"""The port's ``repro_torch.data.DataLoader`` (data/pipeline.py) against
the reference's ``repro.data.DataLoader``: the same batches, bitwise, in
the same order, over shuffled epochs."""
import numpy as np
import pytest

from repro.data import DataLoader as RefDataLoader
from repro_torch.data import DataLoader

pytestmark = pytest.mark.torch


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3)).astype(np.float32),
            "y": rng.integers(0, 10, n).astype(np.int32),
            "tokens": rng.integers(0, 512, (n, 5))}


@pytest.mark.parametrize("n,batch,drop,seed", [
    (64, 8, True, 0), (50, 8, True, 1), (50, 8, False, 1), (7, 16, False, 2),
    (7, 16, True, 3), (33, 1, True, 4)])
def test_batches_are_the_references(n, batch, drop, seed):
    arrays = _arrays(n, seed)
    ref = RefDataLoader(arrays, batch, seed=seed, drop_remainder=drop)
    got = DataLoader(arrays, batch, seed=seed, drop_remainder=drop)
    assert got.n == ref.n == n
    want_epochs, got_epochs = list(ref.epochs(3)), list(got.epochs(3))
    assert len(got_epochs) == len(want_epochs)
    assert len(got_epochs) == 3 * (n // batch if drop else -(-n // batch))
    for w, g in zip(want_epochs, got_epochs):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_arrays_must_share_the_sample_dim():
    with pytest.raises(ValueError, match="sample dim"):
        DataLoader({"x": np.zeros(4), "y": np.zeros(5)}, 2)
