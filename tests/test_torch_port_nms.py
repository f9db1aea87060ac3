"""The port's NMS against the JAX package's, on the CPU.

``nms_keep`` (a problem without categories, as each RPN level is one),
``batched_nms`` (the box head's category-aware problem) and
``nms_keep_levels`` (the RPN's five levels in one call) go through the
``hnd_ghnd::nms_keep`` and ``hnd_ghnd::nms_keep_levels`` ops of
ops/library.py, whose CPU implementations are the plain fixpoint on each
problem's (each level's) valid boxes.  Their keep masks equal those of JAX's
``nms_keep_mask`` / ``batched_nms_mask`` exactly, and ``batched_nms``'s
survivors JAX's ``batched_nms``, on seeded problems
(``chip_smoke.nms_problem``): tied scores (-0.0 and 0.0 among them),
duplicate boxes, zero-area boxes, invalid rows, no categories, one and
many, N of 1, 63, 64, 65 and 1000 (the kernel's word of 64 boxes and its
edges); ``stable_topk`` orders as ``jax.lax.top_k`` (XLA's total order of
floats).  The plain version on each problem's valid boxes equals the
fixpoint of the whole [B, N, N] relation.  ``nms_keep_levels`` equals
JAX's ``nms_keep_mask`` on each level (hnd_ghnd_tpu/models/rpn.py:143's
use) on seeded five-level problems of up to 64 boxes a level, and the
fixpoint of the concatenated problem with the level as the category (the
identity the kernel's one entry for all levels relies on); the tolerance
is none: equal masks.  chip_smoke.py holds the CUDA kernel against the
plain version on the card, NaN and +-inf included.

The port's torch work runs in a spawned process on two threads
(tests/test_torch_port_multiprocess.py's ``Ranks``), leaving this
process's threads alone; JAX runs here.
"""
import numpy as np
import pytest

from chip_smoke import nms_problem
from tests.test_torch_port_multiprocess import Ranks

BATCH = 2
SIZES = (1, 63, 64, 65, 1000)
# (categories: 0 for none, else their number; IoU threshold): the RPN's
# 0.7 without categories, the box head's 0.5 with them
KINDS = ((0, 0.7), (1, 0.5), (90, 0.5), (3, 0.5))
MAX_OUTPUTS = 100
# the RPN's levels at a test's size: ends of a 64-box tile, one box
LEVEL_SIZES = ((64, 40, 1, 63, 17), (33, 64, 5, 2, 50))


def _level_problems():
    rng = np.random.RandomState(18)
    out = []
    for sizes in LEVEL_SIZES:
        parts = [nms_problem(rng, BATCH, n, 0, False) for n in sizes]
        out.append([(b.numpy(), s.numpy(), v.numpy()) for b, s, v, _ in
                     parts])
    return out


def _problems():
    rng = np.random.RandomState(16)
    out = []
    for n in SIZES:
        for n_cats, thr in KINDS:
            boxes, scores, valid, cats = nms_problem(rng, BATCH, n, n_cats,
                                                     False)
            out.append((f"N={n} cats={n_cats}", boxes.numpy(),
                        scores.numpy(), valid.numpy(),
                        None if cats is None else cats.numpy(), thr))
    return out


def _topk_inputs():
    """Rows of tied floats with signed zeros, +-inf and NaN of both signs,
    as float32 and as the bits of JAX's bfloat16 casts of them."""
    import jax.numpy as jnp
    rng = np.random.RandomState(17)
    values = np.float32([-0.0, 0.0, 1.0, np.nan, -np.nan, -np.inf, np.inf,
                         0.5, -0.5])
    x = rng.choice(values, (4, 40))
    return x, np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                         .view(jnp.int16))


def task_port_topk(x, bf16_bits, k):
    """``stable_topk`` of float32 ``x`` and of the bfloat16 bits."""
    import torch
    from hnd_ghnd_tpu_torch.ops.nms import stable_topk
    bf16 = torch.from_numpy(bf16_bits.copy()).view(torch.bfloat16)
    out = []
    for t in (torch.from_numpy(x), bf16):
        vals, idx = stable_topk(t, k)
        out.append((vals.float().numpy(), idx.numpy()))
    return out


def task_port_nms(problems):
    """The port's keep masks (``nms_keep``, without categories and with
    them), the whole-relation fixpoint's, and ``batched_nms``'s
    survivors."""
    import torch
    from hnd_ghnd_tpu_torch.ops import nms
    out = []
    for _, boxes, scores, valid, cats, thr in problems:
        b, s, v = (torch.from_numpy(a) for a in (boxes, scores, valid))
        c = None if cats is None else torch.from_numpy(cats)
        if c is None:
            keep = nms.nms_keep(b, s, thr, v)
            survivors = None
        else:
            keep = nms.nms_keep(b, s, thr, v, c)
            idx, ok = nms.batched_nms(b, s, c, thr, MAX_OUTPUTS, v)
            survivors = (idx.numpy(), ok.numpy())
        (whole,) = nms.fixpoint([nms._suppression(b, s, thr, v, c)], [v])
        out.append((keep.numpy(), whole.numpy(), survivors))
    return out


def task_port_levels(problems, thr):
    """``nms_keep_levels`` of each set of levels (concatenated along dim
    1), and the fixpoint of the concatenation with the level as the
    category."""
    import torch
    from hnd_ghnd_tpu_torch.ops import nms
    out = []
    for levels in problems:
        sizes = [b.shape[1] for b, _, _ in levels]
        b, s, v = (torch.cat([torch.from_numpy(p[i]) for p in levels], 1)
                   for i in range(3))
        keep = nms.nms_keep_levels(b, s, thr, v, sizes)
        level = torch.cat([torch.full((b.shape[0], n), i)
                           for i, n in enumerate(sizes)], 1)
        (whole,) = nms.fixpoint([nms._suppression(b, s, thr, v, level)], [v])
        out.append((keep.numpy(), whole.numpy()))
    return out


TOP_K = 23
# the RPN's NMS threshold (models/rpn.py NMS_THRESH)
RPN_THRESH = 0.7


@pytest.fixture(scope="module")
def port():
    pool = Ranks(world=1, module=__name__, init_group=False)
    try:
        problems = _problems()
        pool.submit("task_port_nms", problems=problems)
        (result,) = pool.collect()
        topk_in = _topk_inputs()
        (topk,) = pool.run("task_port_topk", x=topk_in[0],
                           bf16_bits=topk_in[1], k=TOP_K)
        levels_in = _level_problems()
        (levels,) = pool.run("task_port_levels", problems=levels_in,
                             thr=RPN_THRESH)
    finally:
        pool.close()
    return problems, result, topk_in, topk, levels_in, levels


def test_stable_topk_is_lax_top_k_order(port):
    """XLA's total order: the survivors' order of ``batched_nms`` and the
    RPN's pre- and post-NMS top-k depend on it where scores tie, -0.0 and
    0.0 included."""
    import jax
    import jax.numpy as jnp

    _, _, (x, bits), topk = port[:4]
    for got, arr in zip(topk, (jnp.asarray(x),
                               jnp.asarray(bits).view(jnp.bfloat16))):
        vals, idx = jax.lax.top_k(arr, TOP_K)
        want = np.asarray(vals).astype(np.float32)
        np.testing.assert_array_equal(got[1], np.asarray(idx))
        # NaN where JAX has NaN (the casts to float32 may give other NaN
        # bits), and the same signs elsewhere (-0.0 and 0.0)
        np.testing.assert_array_equal(got[0], want)
        finite = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(got[0])[finite],
                                      np.signbit(want)[finite])


def test_keep_masks_equal_jax(port):
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.ops import nms as jnms

    problems, result = port[:2]
    plain = jax.jit(jax.vmap(jnms.nms_keep_mask, in_axes=(0, 0, None, 0)),
                    static_argnums=2)
    by_category = jax.jit(jax.vmap(jnms.batched_nms_mask,
                                   in_axes=(0, 0, 0, None, 0)),
                          static_argnums=3)
    kept = 0
    for (name, boxes, scores, valid, cats, thr), (keep, whole, _) in zip(
            problems, result):
        if cats is None:
            want = plain(jnp.asarray(boxes), jnp.asarray(scores), thr,
                         jnp.asarray(valid))
        else:
            want = by_category(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(cats), thr, jnp.asarray(valid))
        np.testing.assert_array_equal(keep, np.asarray(want), err_msg=name)
        np.testing.assert_array_equal(whole, keep, err_msg=name)
        kept += int(keep.sum())
    # the cases keep some boxes and suppress others
    n_valid = sum(int(p[3].sum()) for p in problems)
    assert 0 < kept < n_valid


def test_batched_nms_survivors_equal_jax(port):
    import jax.numpy as jnp
    from hnd_ghnd_tpu.ops import nms as jnms

    problems, result = port[:2]
    checked = 0
    for (name, boxes, scores, valid, cats, thr), (_, _, survivors) in zip(
            problems, result):
        if cats is None:
            continue
        idx, ok = survivors
        for i in range(BATCH):
            j_idx, j_ok = jnms.batched_nms(
                jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                jnp.asarray(cats[i]), thr, min(MAX_OUTPUTS, boxes.shape[1]),
                jnp.asarray(valid[i]))
            k = int(np.asarray(j_ok).sum())
            np.testing.assert_array_equal(ok[i], np.asarray(j_ok),
                                          err_msg=name)
            np.testing.assert_array_equal(idx[i, :k], np.asarray(j_idx)[:k],
                                          err_msg=name)
            checked += k
    assert checked > 0


def test_levels_keep_equals_jax_per_level(port):
    """The RPN's five levels in one ``nms_keep_levels`` call: equal to
    JAX's ``nms_keep_mask`` on each level, as JAX's RPN runs it, and to the
    fixpoint of the concatenated problem with the level as the
    category."""
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.ops import nms as jnms

    levels_in, levels = port[4:]
    plain = jax.jit(jax.vmap(
        lambda b, s, v: jnms.nms_keep_mask(b, s, RPN_THRESH, v)))

    def padded(a, n):
        """A level padded to 64 boxes with invalid ones (one compiled
        shape): they neither suppress nor are kept, and the level's boxes
        keep their indices."""
        return jnp.asarray(np.pad(a, [(0, 0), (0, 64 - n)]
                                  + [(0, 0)] * (a.ndim - 2)))

    kept = 0
    for sizes, problem, (keep, whole) in zip(LEVEL_SIZES, levels_in, levels):
        want = np.concatenate([np.asarray(plain(
            padded(b, n), padded(s, n), padded(v, n)))[:, :n]
            for (b, s, v), n in zip(problem, sizes)], 1)
        np.testing.assert_array_equal(keep, want, err_msg=str(sizes))
        np.testing.assert_array_equal(whole, keep, err_msg=str(sizes))
        kept += int(keep.sum())
    n_valid = sum(int(v.sum()) for problem in levels_in for _, _, v in problem)
    assert 0 < kept < n_valid
