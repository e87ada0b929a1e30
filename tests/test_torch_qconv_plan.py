"""The conv kernels' launch plan (``kernels/qconv.py: plan``) on the CPU.

The CUDA kernels (``csrc/qconv.cu``) run only on the card; everything they
take from the host is held here, on every conv the zoo's Engines send to
them (ResNet-50 default, ``phase_stem`` and ``optimize``, GoogLeNet,
SqueezeNet v1.1, SSD) at batch 64 and 1 and on the ragged shapes of
``chip_smoke.py``: the tiles cover each output element once; each
reduction index is read once, pot4 in the split-half order; the copy width
divides C (and K/2 for pot4); a gather of the unpadded NHWC image that
follows the plan's table as the kernels do (row origins, patch offsets,
zero fill) gives exactly ``F.unfold``'s im2col columns of the TF-SAME
padded image; and those columns through ``torch._int_mm`` and
``shift_matmul.epilogue`` equal ``qconv_plain`` and the reference's conv
(``tf2_tpu.kernels.dispatch.qconv2d`` off the TPU, its XLA path) on
numpy-seeded inputs, tolerance 0. No test enters Pallas interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf2_tpu.graph.ir import Node as RefNode
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu_torch.kernels import qconv, shift_matmul
from tf2_tpu_torch.transform import potq

# every distinct conv-kernel call of the zoo's Engines, per image: (H, W, C),
# kshape, strides, pads, wfmt (bench/qconv_ab.conv_shapes; checked by
# test_zoo_shapes_are_the_engines)
ZOO = [
    ((224, 224, 3), (7, 7, 3, 64), (2, 2), ((2, 3), (2, 3)), 'int8'),
    ((56, 56, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((56, 56, 256), (1, 1, 256, 512), (2, 2), ((0, 0), (0, 0)), 'pot4'),
    ((56, 56, 128), (3, 3, 128, 128), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((28, 28, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((28, 28, 512), (1, 1, 512, 1024), (2, 2), ((0, 0), (0, 0)), 'pot4'),
    ((28, 28, 256), (3, 3, 256, 256), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((14, 14, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 1024), (1, 1, 1024, 2048), (2, 2), ((0, 0), (0, 0)), 'pot4'),
    ((14, 14, 512), (3, 3, 512, 512), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((7, 7, 512), (3, 3, 512, 512), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((224, 115, 6), (7, 4, 6, 64), (2, 1), ((2, 3), (0, 0)), 'int8'),
    ((115, 115, 12), (4, 4, 12, 64), (1, 1), ((0, 0), (0, 0)), 'int8'),
    ((56, 56, 64), (3, 3, 64, 192), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((28, 28, 96), (3, 3, 96, 128), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((28, 28, 16), (5, 5, 16, 32), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((28, 28, 128), (3, 3, 128, 192), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((28, 28, 32), (5, 5, 32, 96), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((14, 14, 96), (3, 3, 96, 208), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 16), (5, 5, 16, 48), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((14, 14, 112), (3, 3, 112, 224), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 24), (5, 5, 24, 64), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((14, 14, 128), (3, 3, 128, 256), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 144), (3, 3, 144, 288), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 32), (5, 5, 32, 64), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((14, 14, 160), (3, 3, 160, 320), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((14, 14, 32), (5, 5, 32, 128), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((7, 7, 160), (3, 3, 160, 320), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((7, 7, 32), (5, 5, 32, 128), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((7, 7, 192), (3, 3, 192, 384), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((7, 7, 48), (5, 5, 48, 128), (1, 1), ((2, 2), (2, 2)), 'pot4'),
    ((224, 224, 3), (3, 3, 3, 64), (2, 2), ((0, 0), (0, 0)), 'int8'),
    ((55, 55, 16), (3, 3, 16, 64), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((27, 27, 32), (3, 3, 32, 128), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((13, 13, 48), (3, 3, 48, 192), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((13, 13, 64), (3, 3, 64, 256), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((256, 256, 3), (3, 3, 3, 32), (2, 2), ((0, 1), (0, 1)), 'int8'),
    ((128, 128, 32), (3, 3, 32, 64), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((64, 64, 64), (3, 3, 64, 64), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((64, 64, 64), (3, 3, 64, 128), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((32, 32, 128), (3, 3, 128, 128), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((32, 32, 128), (3, 3, 128, 256), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((16, 16, 256), (3, 3, 256, 256), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((8, 8, 256), (3, 3, 256, 256), (2, 2), ((0, 1), (0, 1)), 'pot4'),
    ((16, 16, 256), (3, 3, 256, 12), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((16, 16, 256), (3, 3, 256, 63), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((8, 8, 256), (3, 3, 256, 12), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((8, 8, 256), (3, 3, 256, 63), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((4, 4, 256), (3, 3, 256, 12), (1, 1), ((1, 1), (1, 1)), 'pot4'),
    ((4, 4, 256), (3, 3, 256, 63), (1, 1), ((1, 1), (1, 1)), 'int8'),
]
# chip_smoke.py's ragged conv cases and the card tests' extra shapes:
# (b, H, W, C, kh, kw, cout, strides, padding, wfmt)
RAGGED = [
    (2, 9, 9, 130, 3, 3, 40, (1, 1), "SAME", "pot4"),
    (2, 13, 13, 24, 3, 3, 32, (2, 2), "VALID", "int8"),
    (2, 15, 15, 32, 3, 3, 64, (1, 1), "SAME", "pot4"),
    (1, 28, 28, 3, 7, 7, 64, (2, 2), "SAME", "int8"),
    (2, 14, 14, 48, 3, 3, 64, (1, 1), "SAME", "pot4"),
    (2, 14, 14, 96, 3, 3, 128, (1, 1), "SAME", "pot4"),
    (2, 14, 14, 112, 3, 3, 224, (1, 1), "SAME", "pot4"),
    (2, 14, 14, 144, 3, 3, 288, (1, 1), "SAME", "pot4"),
    (2, 14, 14, 24, 5, 5, 64, (1, 1), "SAME", "pot4"),
    (2, 14, 14, 16, 5, 5, 48, (1, 1), "SAME", "pot4"),
    (2, 8, 8, 256, 3, 3, 12, (1, 1), "SAME", "pot4"),
    (2, 8, 8, 256, 3, 3, 63, (1, 1), "SAME", "pot4"),
    (2, 4, 4, 256, 3, 3, 63, (1, 1), "SAME", "int8"),
    (1, 7, 7, 512, 3, 3, 512, (1, 1), "SAME", "pot4"),
    (64, 28, 28, 128, 3, 3, 128, (1, 1), "SAME", "pot4"),
    (32, 28, 28, 64, 3, 3, 64, (1, 1), "SAME", "pot4"),
    (1, 224, 224, 3, 7, 7, 64, (2, 2), "SAME", "int8"),
    (1, 256, 256, 3, 3, 3, 32, (2, 2), "SAME", "int8"),
    (3, 11, 10, 6, 3, 3, 30, (2, 2), "SAME", "pot4"),
    (3, 17, 9, 2, 5, 3, 40, (2, 1), ((2, 2), (0, 0)), "int8"),
    (2, 63, 32, 6, 3, 2, 64, (2, 1), ((0, 0), (0, 0)), "int8"),
    (1, 31, 16, 8, 7, 4, 72, (2, 1), ((3, 3), (0, 0)), "int8"),
]


def _case(entry, batch):
    """-> (b, h, w, c, kshape, strides, pads, wfmt, oh, ow)."""
    if len(entry) == 5:
        (h, w, c), kshape, strides, pads, wfmt = entry
        b = batch
    else:
        b, h, w, c, kh, kw, n, strides, padding, wfmt = entry
        kshape = (kh, kw, c, n)
        pads = qconv.resolve_pads(padding, kh, kw, *strides, h, w)
    (ph0, ph1), (pw0, pw1) = pads
    oh = qconv.out_size(h, kshape[0], strides[0], ph0, ph1)
    ow = qconv.out_size(w, kshape[1], strides[1], pw0, pw1)
    return b, h, w, c, tuple(kshape), tuple(strides), pads, wfmt, oh, ow


def _plan(case):
    b, h, w, c, (kh, kw, _, n), (sh, sw), _, wfmt, oh, ow = case
    return qconv.plan(b, h, w, c, oh, ow, kh, kw, sh, sw, n, wfmt == "pot4")


CASES = [pytest.param(_case(e, b), id=f"zoo{i}-b{b}") for i, e in enumerate(ZOO)
         for b in (64, 1)] + [pytest.param(_case(e, None), id=f"ragged{i}")
                              for i, e in enumerate(RAGGED)]
# the gather runs at batch 2 under the plan a batch-64 call (or a ragged one
# of batch 2 or more) takes, and at batch 1 under its own
GATHER = [pytest.param(_case(e, 64), 2, id=f"zoo{i}-b64plan") for i, e in enumerate(ZOO)] + \
    [pytest.param(_case(e, 1), 1, id=f"zoo{i}-b1") for i, e in enumerate(ZOO)] + \
    [pytest.param(_case(e, None), min(e[0], 2), id=f"ragged{i}") for i, e in enumerate(RAGGED)]


def _k_of_column(k, pot4, step, j):
    """The reduction index of column j of a pipelined K step (qgemm.cuh's
    split-half order for pot4), or None past K."""
    if pot4:
        r = 32 * step + j % 32
        return (r if j < 32 else k // 2 + r) if r < k // 2 else None
    return 64 * step + j if 64 * step + j < k else None


@pytest.mark.parametrize("case", CASES)
def test_plan_tiles_cover_each_output_once(case):
    b, _, _, _, kshape, _, _, _, oh, ow = case
    p = _plan(case)
    n = kshape[3]
    hits = np.zeros((b * oh * ow, -(-n // p.bn) * p.bn), np.int32)
    if p.tile_h:  # a 2-D pixel tile of one image a block
        ty, tx = -(-oh // p.tile_h), -(-ow // p.tile_w)
        assert p.grid == (b * ty * tx, -(-n // p.bn))
        rows = np.arange(p.bm)
        for blk in range(p.grid[0]):
            img, t = divmod(blk, ty * tx)
            oy = t // tx * p.tile_h + rows // p.tile_w
            ox = t % tx * p.tile_w + rows % p.tile_w
            keep = (rows < p.tile_h * p.tile_w) & (oy < oh) & (ox < ow)
            hits[(img * oh + oy[keep]) * ow + ox[keep]] += 1
    else:
        assert p.grid == (-(-b * oh * ow // p.bm), -(-n // p.bn))
        for blk in range(p.grid[0]):
            hits[blk * p.bm:(blk + 1) * p.bm] += 1
    # every N tile of a block covers its BN columns; past N they are not stored
    assert (hits[:, :n] == 1).all()
    assert p.smem <= qconv.SMEM_LIMIT


@pytest.mark.parametrize("case", CASES)
def test_plan_reads_each_k_once_in_split_half_order(case):
    _, _, w, c, (kh, kw, cin, _), _, _, wfmt, _, _ = case
    p = _plan(case)
    k, pot4 = kh * kw * cin, wfmt == "pot4"
    seen = np.zeros(k, np.int32)
    if p.variant == qconv.STAGED:  # natural order, one entry a column
        assert p.table.shape == (-(-k // 32) * 32,)
        for kk, t in enumerate(p.table):
            if t < 0:
                assert kk >= k
                continue
            dy, e = t >> 16, t & 0xFFFF
            assert (dy * kw * c + e) == kk
            seen[kk] += 1
    else:
        steps = -(-(k // 2) // 32) if pot4 else -(-k // 64)
        chunk = 16 if p.variant >= qconv.PATCH else p.avec
        assert p.table.shape[:2] == (steps, 64 // chunk)
        for s in range(steps):
            for q in range(64 // chunk):
                want = _k_of_column(k, pot4, s, q * chunk)
                entry = p.table[s, q]
                if p.variant >= qconv.PATCH:
                    if want is None:
                        assert entry == -1
                        continue
                    ph, pw, cps = qconv.patch_geometry(c, kh, kw, *case[5], p.tile_h, p.tile_w)
                    tap, ci = divmod(int(entry), cps)
                    dy, dx = divmod(tap, pw)
                else:
                    off, dydx = entry
                    if want is None:
                        assert dydx >> 16 == 0x7FFF
                        continue
                    dy, dx = dydx >> 16, dydx & 0xFFFF
                    ci = off - (dy * w + dx) * c
                assert (dy * kw + dx) * c + ci == want
                for e in range(chunk):  # the chunk's indices, one tap, contiguous
                    assert _k_of_column(k, pot4, s, q * chunk + e) == want + e
                seen[want:want + chunk] += 1
    assert (seen == 1).all()
    if p.splits > 1:  # split-K: runs of the K steps, none empty
        steps = p.table.shape[0]
        per = -(-steps // p.splits)
        assert (p.splits - 1) * per < steps and p.bm <= 128 and p.variant != qconv.STAGED


@pytest.mark.parametrize("case", CASES)
def test_plan_copy_width_divides_c(case):
    _, _, _, c, (kh, kw, _, n), _, _, wfmt, _, _ = case
    p = _plan(case)
    k = kh * kw * c
    if p.variant == qconv.STAGED:
        assert c % 4 or (wfmt == "pot4" and (k // 2) % 4)  # no 4-byte copy fits
        return
    assert p.avec in (16, 8, 4) and c % p.avec == 0
    if wfmt == "pot4":
        assert (k // 2) % p.avec == 0
    assert p.bvec == 0 or n % p.bvec == 0
    if p.variant >= qconv.PATCH:
        assert p.avec == 16 and kh * kw > 1 and case[5] == (1, 1)


def _gather(x, case, p):
    """The im2col matrix (B*OH*OW, K) in HWIO order, read from the unpadded
    NHWC image as the kernels read it: each row's origin worked out once,
    each K chunk from the plan's table, zero where the tap is padding."""
    b, h, w, c, (kh, kw, cin, _), (sh, sw), ((pt, _), (pl, _)), wfmt, oh, ow = case
    b = x.shape[0]
    k, pot4 = kh * kw * cin, wfmt == "pot4"
    xf = x.reshape(-1)
    out = np.zeros((b * oh * ow, k), np.int8)
    m = np.arange(b * oh * ow)
    img, oy, ox = m // (oh * ow), m // ow % oh, m % ow
    if p.variant == qconv.STAGED:
        # the patch of each tile, zero padded, from the table's (dy, dx * C + c)
        for kk, t in enumerate(p.table[:k]):
            dy, e = t >> 16, t & 0xFFFF
            dx, ci = divmod(e, c)
            iy, ix = oy * sh - pt + dy, ox * sw - pl + dx
            inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            src = ((img * h + iy) * w + ix) * c + ci
            out[inb, kk] = xf[src[inb]]
        return out
    if p.variant >= qconv.PATCH:
        ph, pw, cps = qconv.patch_geometry(c, kh, kw, sh, sw, p.tile_h, p.tile_w)
        rng = np.random.default_rng(0)
        ty, tx = -(-oh // p.tile_h), -(-ow // p.tile_w)
        for blk in range(b * ty * tx):
            im, t = divmod(blk, ty * tx)
            oy0, ox0 = t // tx * p.tile_h, t % tx * p.tile_w
            # the patch: stride cps, its pad bytes random (never read)
            patch = rng.integers(-128, 128, (ph, pw, cps), dtype=np.int8)
            iy = oy0 * sh - pt + np.arange(ph)[:, None]
            ix = ox0 * sw - pl + np.arange(pw)[None, :]
            inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            patch[:, :, :c] = 0
            patch[inb, :c] = x[im][np.broadcast_to(iy, inb.shape)[inb],
                                   np.broadcast_to(ix, inb.shape)[inb]]
            flat = patch.reshape(-1)
            rows = np.arange(p.tile_h * p.tile_w)
            py, px = oy0 + rows // p.tile_w, ox0 + rows % p.tile_w
            keep = (py < oh) & (px < ow)
            pix = ((rows // p.tile_w) * sh * pw + (rows % p.tile_w) * sw) * cps
            mrow = (im * oh + py[keep]) * ow + px[keep]
            for s in range(p.table.shape[0]):
                for q in range(4):
                    kk = _k_of_column(k, pot4, s, 16 * q)
                    off = p.table[s, q]
                    if kk is None:
                        continue
                    out[mrow[:, None], kk + np.arange(16)] = \
                        flat[pix[keep][:, None] + off + np.arange(16)]
        return out
    iy0, ix0 = oy * sh - pt, ox * sw - pl
    base = ((img * h + iy0) * w + ix0) * c
    for s in range(p.table.shape[0]):
        for q in range(p.table.shape[1]):
            off, dydx = p.table[s, q]
            dy, dx = dydx >> 16, dydx & 0xFFFF
            kk = _k_of_column(k, pot4, s, q * p.avec)
            if dy == 0x7FFF:
                assert kk is None
                continue
            inb = (iy0 + dy >= 0) & (iy0 + dy < h) & (ix0 + dx >= 0) & (ix0 + dx < w)
            src = base[inb][:, None] + off + np.arange(p.avec)
            out[np.flatnonzero(inb)[:, None], kk + np.arange(p.avec)] = xf[src]
    return out


def _operands(case, b, seed):
    _, h, w, c, kshape, _, _, wfmt, _, _ = case
    kh, kw, cin, n = kshape
    k = kh * kw * cin
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    if wfmt == "pot4":
        wparam = potq.pack_codes(rng.integers(0, 16, (k, n)).astype(np.uint8))
    else:
        wparam = rng.integers(-127, 128, kshape, dtype=np.int8)
    es = (rng.uniform(0.5, 3.0, n) / (64 * np.sqrt(k))).astype(np.float32)
    eb = rng.normal(0, 5, n).astype(np.float32)
    return x, wparam, es, eb


@pytest.mark.parametrize("case,batch", GATHER)
def test_plan_gather_is_unfold_and_matches_plain_and_reference(case, batch):
    b = batch
    p = _plan(case)
    _, h, w, c, kshape, strides, pads, wfmt, oh, ow = case
    kh, kw, cin, n = kshape
    x, wparam, es, eb = _operands(case, b, seed=oh * 131 + c)
    cols = _gather(x, case, p)
    (ph0, ph1), (pw0, pw1) = pads
    xp = F.pad(torch.as_tensor(x).permute(0, 3, 1, 2).to(torch.float32), (pw0, pw1, ph0, ph1))
    unf = F.unfold(xp, (kh, kw), stride=strides)  # (B, C*kh*kw, L), (c, dy, dx) order
    unf = unf.reshape(b, cin, kh, kw, oh * ow).permute(0, 4, 2, 3, 1).reshape(-1, kh * kw * cin)
    np.testing.assert_array_equal(cols, unf.to(torch.int8).numpy())
    # through the integer GEMM and the shared epilogue
    w_q = qconv.decode_hwio(torch.as_tensor(wparam), wfmt, kshape).reshape(-1, n)
    acc = torch._int_mm(torch.as_tensor(cols), w_q.contiguous())
    tt = [torch.as_tensor(a) for a in (x, wparam, es, eb)]
    got = shift_matmul.epilogue(acc, tt[2], tt[3], True).reshape(b, oh, ow, n)
    plain = qconv.qconv_plain(*tt, strides=strides, kshape=kshape, pads=pads, relu=True,
                              wfmt=wfmt)
    assert torch.equal(got, plain)
    node = RefNode("c", "qconv2d", ("x",), ("w", "es", "eb"), {
        "kshape": list(kshape), "strides": list(strides), "groups": 1, "relu": True,
        "wfmt": wfmt, "padding": [list(pads[0]), list(pads[1])]})
    prev = ref_dispatch._USE_PALLAS
    ref_dispatch.set_use_pallas(False)
    try:
        want = np.asarray(ref_dispatch.qconv2d(node, {"w": jnp.asarray(wparam),
                                                      "es": jnp.asarray(es),
                                                      "eb": jnp.asarray(eb)}, jnp.asarray(x)))
    finally:
        ref_dispatch.set_use_pallas(prev)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((want != 0).sum()) > want.size // 8


def test_plan_reaches_every_variant():
    """The zoo, the ragged shapes and the smallest grids together take
    every variant csrc/qconv.cu has."""
    cases = [_case(e, b) for e in ZOO for b in (64, 1)] + [_case(e, None) for e in RAGGED]
    got = {_plan(c).variant for c in cases}
    assert got == set(range(qconv.PATCH + len(qconv.PIPE_TILES))), got


def test_zoo_shapes_are_the_engines():
    from tf2_tpu_torch.bench.qconv_ab import MODELS, conv_shapes

    seen = set()
    for name, build_kw, flags in MODELS:
        for x, kshape, strides, pads, wfmt in conv_shapes(name, build_kw, flags):
            seen.add((tuple(x[1:]), tuple(kshape), tuple(strides),
                      tuple(tuple(q) for q in pads), wfmt))
    assert seen == set(ZOO)
