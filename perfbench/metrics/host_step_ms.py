"""host_step_ms (launcher and executor): the host's milliseconds a traced
step inside the program's step function, the sum of its depth-0 phase
spans (vfl-zoo: zoo.draws ... zoo.hist_write; lm: lm.forward,
lm.backward, lm.adam). Against the traced step's wall time
(``window_s / steps``) it says whether the host or the device paces
the cell. The spans also hold the host's waits on a full launch queue:
where the device paces the cell, the value follows the device's time
(lm.qwen15.b8s2048 on an H100 reads 416-428 ms against a traced step
wall of 432-444 ms) and is not the host's cost of issuing the work
alone."""
from perfbench import spans


def read(rec):
    return spans.ms_per_step(rec, lambda name, depth: depth == 0)
