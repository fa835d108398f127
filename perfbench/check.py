"""The comparison that decides ``correct`` for a training cell: what the
program's first steps produced, held against the plain reference's
steps from the same inputs. Each side's readings are

  losses        the loss of each of the first steps
  grad          {leaf: norm of the first gradient as the optimizer applied
                it} (for Adam, its first moment after step 1 over 1 - b1;
                for the zeroth-order step, the leaf's change over step 1,
                the learning rate cancelling in every gap below)
  change        {leaf: norm of the leaf's change over the steps}
  first_update  (zeroth-order steps) the leaves before and after step 1,
                two lists of (name, leaf)

and the numbers compared from them, with leaves in sorted-key order:

  loss_gap           |loss_p - loss_r| / |loss_r| of step 1
  loss_gap_steps     the same, the largest over the steps
  grad_gap           the worst leaf's gap between the ``grad`` norms
  change_gap         the worst leaf's gap between the ``change`` norms
  party_dir_gap      the worst party leaf's 1 - |cos| between the two
                     first updates: the direction of the first update,
                     whatever its scale and sign (the party block is held
                     in f32, so its update is never lost to rounding)
  w0_dir_gap         1 - |cos| between the two first updates of the
                     server's w0, its kept leaves joined into one vector
                     (the large matrices weigh most: each element's
                     update is a whole step of the weight type's
                     rounding, or none)
  w0_shared_dir_gap  the same over the elements that both updates moved:
                     the direction alone, whatever the coefficient that
                     decides how many elements cross a rounding step

A leaf's gap is |norm_p - norm_r| over the larger of norm_r and the
median leaf's norm_r. A leaf whose ``grad`` in the reference is under a
thousandth of the median leaf's is left out of every leaf number: it
moves by round-off alone. A cell's limits file names the numbers that
decide ``correct``; each passes when it is at most its limit.
"""
from __future__ import annotations

import statistics

import torch

PIECE = 1 << 24
TINY_SHARE = 1e-3


def named_leaves(tree, prefix="") -> list:
    """(name, tensor) of a tree of dicts, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def host_copy(pairs) -> list:
    """The leaves copied to the host, so the device holds no second copy
    of the state."""
    return [(n, t.detach().to("cpu")) for n, t in pairs]


def _pieces(a, b, device):
    a, b = a.reshape(-1), b.reshape(-1)
    for s in range(0, b.numel(), PIECE):
        yield (a[s:s + PIECE].to(device).double(),
               b[s:s + PIECE].to(device).double())


def _same(name, a, name_b, b):
    if name != name_b or a.shape != b.shape:
        raise ValueError(f"leaves differ: {name} {tuple(a.shape)} vs "
                         f"{name_b} {tuple(b.shape)}")


@torch.no_grad()
def change_norms(old, new) -> dict:
    """{name: ||new - old||}, piece by piece; ``old`` may be on the host."""
    out = {}
    for (name, a), (name_b, b) in zip(old, new):
        _same(name, a, name_b, b)
        out[name] = float(sum(torch.sum((y - x) ** 2)
                              for x, y in _pieces(a, b, b.device)) ** 0.5)
    return out


def _cos(dot, na, nr) -> float:
    return dot / (na * nr) ** 0.5 if na and nr else 0.0


@torch.no_grad()
def dots(update, ref, device) -> dict:
    """{name: (u . r, u . u, r . r, u . u and r . r over the elements that
    both moved)} leaf by leaf between two first updates u and r, each
    (before, after), piece by piece on ``device``."""
    out = {}
    for (name, a), (name_b, b), (name_r, ra), (_, rb) in zip(
            *update, *ref):
        _same(name, a, name_b, b)
        _same(name, a, name_r, ra)
        sums = [0.0] * 5
        for (x, y), (xr, yr) in zip(_pieces(a, b, device),
                                    _pieces(ra, rb, device)):
            d, z = y - x, yr - xr
            for i, t in enumerate((d * z, d * d, z * z, d * d * (z != 0),
                                   z * z * (d != 0))):
                sums[i] += float(torch.sum(t))
        out[name] = tuple(sums)
    return out


def _kept(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return [n for n in ref_grad if ref_grad[n] >= TINY_SHARE * med]


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> tuple:
    """(worst gap, its leaf) over the leaves that the rule keeps."""
    if set(prog) != set(ref):
        raise ValueError(f"leaf names differ: {sorted(set(prog) ^ set(ref))}")
    kept = _kept(ref_grad)
    med = statistics.median(ref[n] for n in kept)
    worst = max(kept, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def numbers(prog: dict, ref: dict, device="cpu") -> dict:
    """Every number the two sides' readings give (see the module's
    docstring), and under "where" the leaf each leaf number came from."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    out = {"loss_gap": gaps[0], "loss_gap_steps": max(gaps), "where": {}}
    for name in ("grad", "change"):
        out[f"{name}_gap"], out["where"][f"{name}_gap"] = leaf_gap(
            prog[name], ref[name], ref["grad"])
    if "first_update" in prog and "first_update" in ref:
        d = dots(prog["first_update"], ref["first_update"], device)
        kept = _kept(ref["grad"])
        party = [n for n in kept if n.startswith("parties.")]
        worst = max(party, key=lambda n: 1 - abs(_cos(*d[n][:3])))
        out["party_dir_gap"] = 1 - abs(_cos(*d[worst][:3]))
        out["where"]["party_dir_gap"] = worst
        w0 = [sum(d[n][i] for n in kept if n.startswith("w0."))
              for i in range(5)]
        out["w0_dir_gap"] = 1 - abs(_cos(*w0[:3]))
        out["w0_shared_dir_gap"] = 1 - abs(_cos(w0[0], *w0[3:]))
    return out


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = float(nums[name])
        out[name] = {"value": v, "limit": float(limit)}
        ok = ok and v == v and v <= float(limit)
    return ok, out
