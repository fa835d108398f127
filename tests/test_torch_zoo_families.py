"""The launcher's vfl-zoo mode with the recurrent families as the server
model F_0: ``python -m repro_torch.launch.train --mode vfl-zoo --reduced``
on rwkv6-1.6b and hymba-1.5b against ``repro.launch.train`` with the same
flags, as the reference's ``make_vfl_zoo_step`` builds on them. Same data,
batch draws and keys, so the same ``h`` per step within the f32
trajectory tolerance of tests/test_torch_zoo.py: the forwards sum in other
orders than XLA's, and the ZO coefficient divides their gaps by mu."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro_torch.launch import train

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TRAJ_TOL = 1e-4


def _h(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, [float(v) for v in re.findall(r" h=(\S+)", out.getvalue())]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_vfl_zoo_launcher_on_the_recurrent_families(arch):
    argv = ["--arch", arch, "--mode", "vfl-zoo", "--reduced", "--steps", "3",
            "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
            "--parties", "4", "--lr", "1e-2"]
    _, want = _h(ref_train.main, argv)
    res, got = _h(train.main, argv + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    np.testing.assert_allclose(res["h"], got, rtol=1e-5)
    assert all(np.isfinite(res["h"]))
