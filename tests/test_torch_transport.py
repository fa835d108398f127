"""The port's TCP framing and ZV v1 message codec against the reference's,
byte for byte, and its checkpoint module on the reference's checkpoint
cases. No processes are spawned here (tests/test_torch_runtime*.py run
the federations)."""
import ast
import json
import os
import socket
import struct
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import VFLConfig as RefVFLConfig
from repro.core.exchange import ZOExchange as RefExchange
from repro.core.wire import Message as RefMessage
from repro.runtime import transport as ref_transport
from repro_torch.checkpoint import (latest_step, load_metadata,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import VFLConfig
from repro_torch.core.exchange import ZOExchange, to_host
from repro_torch.core.wire import SERVER, Message, party
from repro_torch.runtime import transport
from repro_torch.runtime.transport import (FramedSocket, TransportTimeout,
                                           decode_message, encode_message)
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ framing --

def _socketpair():
    a, b = socket.socketpair()
    return FramedSocket(a), FramedSocket(b)


def test_framed_socket_roundtrips_messages_and_controls():
    a, b = _socketpair()
    msg = Message.make("c_up", party(0), SERVER, 2,
                       np.arange(6, dtype=np.float32),
                       meta={"idx": np.arange(6), "dir": 0})
    a.send_message(msg)
    a.send_control({"type": "ping"})
    kind, got = b.recv(timeout=5.0)
    assert kind == "msg"
    assert (got.kind, got.sender, got.round, got.nbytes) == \
        ("c_up", party(0), 2, 24)
    np.testing.assert_array_equal(got.payload, msg.payload)
    np.testing.assert_array_equal(got.meta["idx"], msg.meta["idx"])
    assert got.meta["dir"] == 0
    kind, got = b.recv(timeout=5.0)
    assert kind == "ctl" and got == {"type": "ping"}
    # measured socket bytes cover the framing on top of the payload
    assert a.bytes_out == b.bytes_in > msg.nbytes
    a.close(), b.close()


def test_framed_socket_timeout_is_typed():
    a, b = _socketpair()
    with pytest.raises(TransportTimeout):
        b.recv(timeout=0.05)
    a.close(), b.close()


def test_recv_survives_mid_frame_timeout():
    """A timeout with a frame partly received must not desynchronize the
    stream: the retried recv() resumes the SAME frame."""
    a, b = _socketpair()
    msg = Message.make("c_up", party(0), SERVER, 0,
                       np.arange(16, dtype=np.float32))
    body = encode_message(msg)
    frame = struct.pack(">I", len(body) + 1) + b"\x00" + body
    a.sock.sendall(frame[:11])                  # header + a few bytes
    with pytest.raises(TransportTimeout):
        b.recv(timeout=0.05)
    a.sock.sendall(frame[11:])                  # the rest arrives late
    kind, got = b.recv(timeout=5.0)
    assert kind == "msg"
    np.testing.assert_array_equal(got.payload, msg.payload)
    a.close(), b.close()


def test_declared_nbytes_is_validated_both_ways():
    msg = Message.make("c_up", party(1), SERVER, 0,
                       np.zeros(4, np.float32), nbytes=12)
    with pytest.raises(transport.WireFormatError, match="nbytes"):
        encode_message(msg)
    good = encode_message(Message.make("c_up", party(1), SERVER, 0,
                                       np.zeros(4, np.float32)))
    # rewrite the declared nbytes (i64 after magic, version, kind and the
    # two endpoint strings) to disagree with the payload
    at = 4 + 4 + len(party(1)) + 4 + len(SERVER) + 8
    bad = good[:at] + struct.pack(">q", 12) + good[at + 8:]
    with pytest.raises(transport.WireFormatError, match="nbytes"):
        decode_message(bad)


# --------------------------------------- the wire against the reference --

B = 16


def _wires(codec, key_seed):
    """The same c through both packages' codecs, as each ships it: the
    reference's payload as numpy (bf16 as ml_dtypes), the port's as
    ``to_host`` gives it (bf16 as uint16 patterns)."""
    c = np.random.default_rng(key_seed).standard_normal(B).astype(np.float32)
    ref_ex = RefExchange.from_config(RefVFLConfig(num_parties=2,
                                                  codec=codec))
    port_ex = ZOExchange.from_config(VFLConfig(num_parties=2, codec=codec))
    ref = jax.tree.map(np.asarray, ref_ex.encode_up(
        jnp.asarray(c), jax.random.key(key_seed)))
    port = to_host(port_ex.encode_up(torch.from_numpy(c),
                                     prng.key(key_seed)))
    return ref, port


def _pair(kind, codec):
    idx = np.arange(B, dtype=np.int64) * 3
    if kind == "loss_down":
        scalars = tuple(float(np.float32(v)) for v in (0.6931, 0.7012))
        return (RefMessage.make(kind, SERVER, party(1), 4, scalars),
                Message.make(kind, SERVER, party(1), 4, scalars))
    meta = {"idx": idx} if kind == "c_up" else {"idx": idx, "dir": 2}
    ref_w, port_w = _wires(codec, 5)
    return (RefMessage.make(kind, party(1), SERVER, 4, ref_w, meta=meta),
            Message.make(kind, party(1), SERVER, 4, port_w, meta=meta))


CASES = [("c_up", "f32"), ("c_up", "bf16"), ("c_up", "int8"),
         ("c_hat_up", "f32"), ("c_hat_up", "bf16"), ("c_hat_up", "int8"),
         ("loss_down", None)]


@pytest.mark.parametrize("kind,codec", CASES,
                         ids=[f"{k}-{c}" for k, c in CASES])
def test_encode_message_is_the_references_bytes(kind, codec):
    ref, port = _pair(kind, codec)
    assert port.nbytes == ref.nbytes
    assert encode_message(port) == ref_transport.encode_message(ref)


def _same_payload(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_payload(g, w)
    elif isinstance(want, float):
        assert isinstance(got, float) and got == want
    else:
        # both packages put a 0-d array on the wire as shape (1,)
        # (np.ascontiguousarray), so the int8 scale reads back 1-d
        want = np.ascontiguousarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind,codec", CASES,
                         ids=[f"{k}-{c}" for k, c in CASES])
def test_decode_message_reads_the_references_bytes(kind, codec):
    ref, port = _pair(kind, codec)
    got = decode_message(ref_transport.encode_message(ref))
    assert (got.kind, got.sender, got.receiver, got.round, got.nbytes) == \
        (port.kind, port.sender, port.receiver, port.round, port.nbytes)
    _same_payload(got.payload, port.payload)
    if kind != "loss_down":
        np.testing.assert_array_equal(got.meta["idx"], port.meta["idx"])
        assert got.meta.get("dir") == port.meta.get("dir")
    # and the reference reads the port's bytes back to its own payload
    back = ref_transport.decode_message(encode_message(port))
    _same_payload(jax.tree.map(np.asarray, back.payload)
                  if kind != "loss_down" else back.payload,
                  ref.payload)


def test_bf16_payloads_decode_without_ml_dtypes(tmp_path):
    """A bf16 frame of the reference decodes in a process where ml_dtypes
    cannot be imported, to the port's uint16 patterns."""
    ref, port = _pair("c_up", "bf16")
    frame = ref_transport.encode_message(ref)
    (tmp_path / "frame.bin").write_bytes(frame)
    code = (
        "import sys, json\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from repro_torch.runtime.transport import decode_message\n"
        f"m = decode_message(open({str(tmp_path / 'frame.bin')!r}, 'rb')"
        ".read())\n"
        "print(json.dumps([m.payload.dtype.name, m.payload.tobytes().hex(),"
        " 'ml_dtypes' in sys.modules and sys.modules['ml_dtypes'] is not "
        "None]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    dtype, raw, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert (dtype, loaded) == ("uint16", False)
    assert bytes.fromhex(raw) == port.payload.tobytes()


def test_runtime_and_checkpoint_import_no_jax_repro_or_ml_dtypes():
    files = sorted((ROOT / "src" / "repro_torch" / "runtime").glob("*.py")) \
        + sorted((ROOT / "src" / "repro_torch" / "checkpoint").glob("*.py"))
    assert len(files) >= 8
    for path in files:
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + \
            [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in mods
               if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
        assert not bad, f"{path.name} imports {bad}"


# ---------------------------------------------------------------- problem --

PROBLEM_SPECS = {
    "lr": {"kind": "lr", "parties": 2, "features": 16, "samples": 64,
           "batch": 8, "seed": 0},
    "lr-q3-d20": {"kind": "lr", "parties": 3, "features": 20, "samples": 50,
                  "batch": 8, "seed": 7},
    "fcn-q3-d20": {"kind": "fcn", "parties": 3, "features": 20,
                   "classes": 10, "samples": 64, "batch": 8, "seed": 0},
    # the D7 shape's features and parties at a few rows
    "fcn-q8-d784": {"kind": "fcn", "parties": 8, "features": 784,
                    "classes": 10, "samples": 96, "batch": 8, "seed": 0},
}


@pytest.mark.parametrize("name", sorted(PROBLEM_SPECS))
def test_build_problem_data_is_the_references_bitwise(name):
    """Every process rebuilds X and y from the spec's seed: the port's
    draws (normal, pad_features, then sign of a normal or randint) give
    the reference's np.asarray(X) and np.asarray(y) bit for bit, with
    q dividing d or not."""
    from repro.runtime.problem import build_problem as ref_build_problem
    from repro_torch.runtime.problem import build_problem
    spec = PROBLEM_SPECS[name]
    ref, port = ref_build_problem(spec), build_problem(spec, "cpu")
    X, rX = port.X.numpy(), np.asarray(ref.X)
    assert X.dtype == rX.dtype == np.float32 and X.shape == rX.shape
    np.testing.assert_array_equal(X.view(np.uint32), rX.view(np.uint32))
    y, ry = port.y.numpy(), np.asarray(ref.y)
    assert y.shape == ry.shape
    if spec["kind"] == "lr":
        np.testing.assert_array_equal(y.view(np.uint32), ry.view(np.uint32))
    else:       # int64 class ids here, the reference's int32
        assert y.dtype == np.int64
        np.testing.assert_array_equal(y, ry.astype(np.int64))
    assert (port.batch_size, port.seed) == (ref.batch_size, ref.seed)


# ------------------------------------------------------------- checkpoint --

def _tree():
    return {"layers": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.bfloat16) * 1.5},
            "step_count": torch.tensor(7, dtype=torch.int32),
            "table": np.arange(4, dtype=np.float32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree, {"note": "x"})
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 5
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16 is stored as its bit patterns, as the wire ships it
    with np.load(tmp_path / "step_00000005.npz") as data:
        assert data["layers/b"].dtype == np.uint16
        assert sorted(data.files) == ["layers/b", "layers/w", "step_count",
                                      "table"]


def test_checkpoint_latest_step_discovery(tmp_path):
    tree = _tree()
    assert latest_step(str(tmp_path)) is None
    for s in (1, 10, 3):
        save_checkpoint(str(tmp_path), s, tree)
    assert latest_step(str(tmp_path)) == 10
    _, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 10


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((3,))})


def test_checkpoint_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((2,)),
                                           "extra": torch.zeros((1,))})


def test_checkpoint_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((1,))})


def test_checkpoint_latest_step_ignores_stray_tmp_files(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree)
    (tmp_path / "tmpabc123.tmp").write_bytes(b"partial npz write")
    (tmp_path / "step_00000099.npz.tmp").write_bytes(b"killed mid-rename")
    assert latest_step(str(tmp_path)) == 3
    _, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 3


def test_checkpoint_metadata_write_is_atomic_and_ordered(tmp_path):
    """The metadata commits by tmp + rename BEFORE the npz rename, so no
    visible step ever lacks its metadata."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree, {"updates": 7})
    assert load_metadata(str(tmp_path), 7) == {"updates": 7}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    real_replace = os.replace

    def exploding_replace(src, dst):
        if dst.endswith(".npz"):
            raise RuntimeError("injected crash before npz commit")
        return real_replace(src, dst)

    with mock.patch("repro_torch.checkpoint.ckpt.os.replace",
                    side_effect=exploding_replace):
        with pytest.raises(RuntimeError):
            save_checkpoint(str(tmp_path), 8, tree, {"updates": 8})
    assert latest_step(str(tmp_path)) == 7          # step 8 never visible
    with open(tmp_path / "step_00000008.json") as f:
        assert json.load(f) == {"updates": 8}       # metadata committed
    assert latest_step(str(tmp_path)) == 7


def test_checkpoint_model_params_roundtrip(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(prng.key(0), "cpu")
    save_checkpoint(str(tmp_path), 2, params)
    restored, _ = restore_checkpoint(str(tmp_path), params)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64),
             "targets": torch.zeros((1, 8), dtype=torch.int64)}
    l1, _ = model.loss(params, batch)
    l2, _ = model.loss(restored, batch)
    assert torch.equal(l1, l2)


def test_checkpoint_restores_a_references_checkpoint(tmp_path):
    """A checkpoint the reference wrote (bf16 widened to f32 there)
    restores into the port's tree, cast back to each leaf's dtype."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    ref_save_checkpoint(str(tmp_path), 4,
                        {"w": jnp.asarray(w),
                         "b": jnp.full((3,), 1.5, jnp.bfloat16)},
                        {"updates": 4})
    like = {"w": torch.zeros((2, 3)),
            "b": torch.zeros((3,), dtype=torch.bfloat16)}
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 4 and load_metadata(str(tmp_path), 4) == {"updates": 4}
    assert torch.equal(got["w"], torch.from_numpy(w))
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], torch.full((3,), 1.5, dtype=torch.bfloat16))
