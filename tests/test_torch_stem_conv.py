"""The port's stem conv (plain K3 and K4, ``StemConv3dFunction``, the gate,
the ``ConvND`` routing) against the JAX package's, which runs its Pallas
kernels in interpret mode here.

Tolerances:
  * forward, float32: 2e-5 absolute and relative, as JAX's own test holds
    its kernel against ``nn.Conv`` (``test_stem_conv_pallas.py:49-55``): the
    same float32 products summed in another order (taps here, a banded GEMM
    there);
  * forward, bfloat16: 1e-2 relative to max|ref|: both sum in float32 and
    round twice (the cast, then the bias add), so an output whose float32
    sums fall on either side of a rounding boundary differs by one bf16 ulp
    (2^-8 relative);
  * gradients, float32: 3e-4, JAX's tolerance for its VJP against
    ``nn.Conv`` (``test_stem_conv_pallas.py:74``);
  * dw in bfloat16: 3e-2 relative to max|dw|: JAX casts each band entry of
    dT to bf16 and sums the band's diagonals in bf16 (``:329-331``), the port
    sums in float32 and casts once;
  * the gate: exactly ``stem_pallas_viable``;
  * K4's summation order (``k4_model``): 1e-5 of max|dw| against the plain
    K4 (the same float32 products summed in another order), 3e-4 against
    JAX's dw as above.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import backbone as jbb  # noqa: E402
from medicaldetectiontoolkit_tpu.ops.stem_conv_pallas import stem_conv3d as jstem  # noqa: E402
from medicaldetectiontoolkit_tpu.ops.stem_conv_pallas import stem_pallas_viable  # noqa: E402
from medicaldetectiontoolkit_torch.models import backbone as tbb  # noqa: E402
from medicaldetectiontoolkit_torch.ops import stem_conv, stem_conv_cuda  # noqa: E402

torch.set_num_threads(2)

SHAPES = [  # (B, Y, X, Z, cin), k, sy, sx: the cases of test_stem_conv_pallas.py:32-39
    ((2, 12, 14, 8, 1), 7, 2, 2),
    ((1, 13, 11, 6, 1), 7, 2, 2),
    ((2, 10, 10, 8, 2), 5, 2, 2),
    ((1, 8, 8, 4, 1), 3, 1, 1),
]


def _inputs(shape, k, seed, cout=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, k, k, shape[-1], cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _to_torch(x, w, b, dtype=torch.float32):
    """Channel-last JAX operands -> the port's channel-first tensors."""
    return (torch.from_numpy(np.moveaxis(x, -1, 1).copy()).to(dtype),
            torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2)).copy()).to(dtype),
            torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,sy,sx", SHAPES)
def test_forward_matches_jax_kernel(shape, k, sy, sx, dtype):
    x, w, b = _inputs(shape, k, seed=0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jstem(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), sy, sx, True), np.float32)
    got = stem_conv.stem_conv3d(*_to_torch(x, w, b, getattr(torch, dtype)), sy, sx)
    assert got.dtype == getattr(torch, dtype)
    got = np.moveaxis(got.float().numpy(), 1, -1)
    assert got.shape == want.shape == (shape[0], -(-shape[1] // sy), -(-shape[2] // sx), shape[3], 6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape,k,sy,sx", [SHAPES[0], SHAPES[1], SHAPES[2]])
def test_gradients_match_jax_vjp(shape, k, sy, sx):
    """dx, dw and db of ``StemConv3dFunction`` against ``jax.grad`` through
    ``stem_conv3d``'s custom VJP (the wgrad kernel in interpret mode)."""
    x, w, b = _inputs(shape, k, seed=1)
    g = np.random.RandomState(2).randn(shape[0], -(-shape[1] // sy), -(-shape[2] // sx), shape[3], 6)
    g = g.astype(np.float32)
    want = jax.grad(lambda *a: jnp.vdot(jstem(*a, sy, sx, True), g), argnums=(0, 1, 2))(x, w, b)

    xt, wt, bt = [t.requires_grad_() for t in _to_torch(x, w, b)]
    out = stem_conv.StemConv3dFunction.apply(xt, wt, bt, sy, sx)
    out.backward(torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    got = (np.moveaxis(xt.grad.numpy(), 1, -1), np.transpose(wt.grad.numpy(), (2, 3, 4, 1, 0)), bt.grad.numpy())
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a, np.asarray(c), atol=3e-4, rtol=3e-4, err_msg=name)


def test_bfloat16_weight_gradient_matches_jax():
    shape, k, sy, sx = SHAPES[0]
    x, w, b = _inputs(shape, k, seed=3)
    g = np.random.RandomState(4).randn(shape[0], 6, 7, shape[3], 6).astype(np.float32)
    bf = jnp.bfloat16
    want = jax.grad(lambda w_: jnp.vdot(jstem(jnp.asarray(x, bf), w_, jnp.asarray(b, bf), sy, sx, True)
                                        .astype(jnp.float32), g), argnums=0)(jnp.asarray(w, bf))
    xt, wt, bt = _to_torch(x, w, b, torch.bfloat16)
    wt.requires_grad_()
    out = stem_conv.StemConv3dFunction.apply(xt, wt, bt, sy, sx)
    out.float().backward(torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    assert wt.grad.dtype == torch.bfloat16
    got = np.transpose(wt.grad.float().numpy(), (2, 3, 4, 1, 0))
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_wgrad_reference_is_the_conv_weight_gradient():
    """The plain K4 against autograd of ``F.conv3d`` (pad k//2, float32)."""
    for (B, Y, X, Z, cin), k, sy, sx in SHAPES:
        x, w, b = _to_torch(*_inputs((B, Y, X, Z, cin), k, seed=5))
        w.requires_grad_()
        out = torch.nn.functional.conv3d(x, w, b, (sy, sx, 1), k // 2)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
        out.backward(g)
        np.testing.assert_allclose(stem_conv.stem_wgrad_reference(x, g, k, sy, sx).numpy(), w.grad.numpy(),
                                   atol=3e-4, rtol=3e-4)


def test_gate_equals_jax():
    shapes = [(2, 128, 128, 64, 1), (4, 64, 64, 8, 2), (1, 32, 32, 256, 1), (2, 16, 16, 64, 3),
              (1, 64, 64, 128, 2), (1, 16, 16, 16, 18)]
    for shape, k, stride, pad in itertools.product(
            shapes, (1, 3, 5, 7), [(1, 1, 1), (2, 2, 1), (2, 2, 2), (1, 2, 1), (3, 3, 1)], (0, 1, 2, 3)):
        tshape = (shape[0], shape[4], *shape[1:4])  # the port sees (B, cin, Y, X, Z)
        ok = stem_conv.stem_viable((tshape[0], *tshape[2:], tshape[1]), k, stride, pad)
        assert ok == stem_pallas_viable(shape, k, stride, pad), (shape, k, stride, pad)


def test_no_third_device():
    x = torch.empty((1, 1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no stem conv implementation"):
        stem_conv.stem_conv3d(x, torch.empty((2, 1, 3, 3, 3), device="meta"), torch.empty(2, device="meta"), 1, 1)


@pytest.mark.parametrize("cin,ks,stride,pad,routed", [
    (1, 7, (2, 2, 1), 3, True),   # Retina Net's C1 stem
    (1, 3, (1, 1, 1), 1, True),   # Retina U-Net's first stem0 conv
    (3, 3, (1, 1, 1), 1, False),  # cin > 2
    (1, 1, (1, 1, 1), 0, False),  # 1x1
])
def test_convnd_routing_matches_jax(monkeypatch, cin, ks, stride, pad, routed):
    """With ``MDT_STEM_PALLAS=1`` the same convs take the stem kernels in
    both packages; converted params give JAX's output either way."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    x = np.random.RandomState(7).randn(2, 12, 12, 8, cin).astype(np.float32)
    jmod = jbb.ConvND(dim=3, features=4, ks=ks, stride=stride, pad=pad, relu="relu")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert set(params) == {"Conv_0"}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    tmod = tbb.ConvND(3, cin, 4, ks=ks, stride=stride, pad=pad, relu="relu")
    with torch.no_grad():
        tmod.conv.weight.copy_(torch.from_numpy(np.transpose(params["Conv_0"]["kernel"], (4, 3, 0, 1, 2)).copy()))
        tmod.conv.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
        got = np.moveaxis(tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy(), 1, -1)
    assert tmod.stem_kernel is routed
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    monkeypatch.delenv("MDT_STEM_PALLAS")
    with torch.no_grad():
        tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert tmod.stem_kernel is False


# --------------------------------------------------------------------- #
#  K4's summation order: a persistent grid of G blocks, block i summing   #
#  chunks i, i + G, ... into its own row, then the rows reduced by one    #
#  warp per output (csrc/stem_conv.cu)                                    #
# --------------------------------------------------------------------- #


def chunk_partials(x, g, k, sy, sx, xt):
    """(B, Yo, ceil(Xo / xt), cout * cin * k^3) float32: each chunk's sum of
    dw, a chunk being (b, yo, xt columns of xo). Each column's sum over z
    first, then the columns summed by the kernel's shuffle tree (column j +=
    column j + off for off = xt/2, ..., 1); the columns past Xo count zero,
    as the kernel's zero-filled g tile does."""
    B, cin = x.shape[:2]
    cout, Yo, Xo, Z = g.shape[1:]
    n_xt = -(-Xo // xt)
    pad = (0, 0, 0, n_xt * xt - Xo)
    gp = torch.nn.functional.pad(g.float(), pad).view(B, cout, Yo, n_xt, xt, Z)
    cols = torch.empty((xt, B, Yo, n_xt, cout, cin, k, k, k))
    for ky, kx, kz, tap in stem_conv._taps(x, k, sy, sx):
        tp = torch.nn.functional.pad(tap, pad).view(B, cin, Yo, n_xt, xt, Z)
        cols[..., ky, kx, kz] = torch.einsum("bcytjz,bdytjz->jbytcd", gp, tp)
    off = xt // 2
    while off:
        cols = cols[:off] + cols[off:2 * off]
        off //= 2
    return cols[0].reshape(B, Yo, n_xt, -1)


def k4_model(x, g, k, sy, sx, xt, capacity):
    """dw (cout, cin, k, k, k) float32 summed in the kernel's order, on the
    port's schedule (``stem_conv_cuda.wgrad_grid`` and ``wgrad_chunks``):
    each chunk's float32 sum added into its block's row in the block's chunk
    order; per output, lane l of a warp sums rows l, l + 32, ... in order
    from 0, then the shuffle tree adds lane l + off into lane l for off =
    16, 8, 4, 2, 1; lane 0 holds dw."""
    parts = chunk_partials(x, g, k, sy, sx, xt)
    B, Yo, n_xt, n_out = parts.shape
    Xo = g.shape[3]
    _, grid = stem_conv_cuda.wgrad_grid(B, Yo, Xo, xt, capacity)
    order = [stem_conv_cuda.wgrad_chunks(i, grid, B, Yo, Xo, xt) for i in range(grid)]
    rows = torch.zeros((grid, n_out))
    for step in range(len(order[0])):  # every block's step-th chunk, blocks side by side
        idx = [i for i, chunks in enumerate(order) if step < len(chunks)]
        b, yo, xo = (torch.tensor(v) for v in zip(*(order[i][step] for i in idx)))
        rows[idx] = rows[idx] + parts[b, yo, xo // xt]
    lanes = torch.zeros((32, n_out))
    for r0 in range(0, grid, 32):
        blk = rows[r0:r0 + 32]
        lanes[:len(blk)] = lanes[:len(blk)] + blk
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:off] + lanes[off:2 * off]
    return lanes[0].view(g.shape[1], x.shape[1], k, k, k)


K4_CASES = [  # (B, Y, X, Z, cin), k, sy, sx, xt, capacity
    ((2, 9, 11, 6, 1), 3, 1, 1, 8, 1),       # one block takes every chunk
    ((2, 9, 11, 6, 1), 3, 1, 1, 8, 5),       # 36 chunks, G 5: no multiple
    ((2, 9, 11, 6, 1), 3, 1, 1, 8, 1000),    # G past the chunks: one chunk each
    ((1, 13, 11, 6, 2), 3, 2, 2, 4, 3),
    ((2, 7, 9, 5, 1), 5, 1, 1, 8, 4),
    ((1, 11, 13, 7, 2), 5, 2, 2, 2, 7),
    ((1, 12, 10, 5, 1), 5, 2, 1, 8, 100),
    ((2, 13, 11, 6, 1), 7, 2, 2, 8, 3),
    ((1, 9, 15, 8, 2), 7, 1, 1, 4, 11),
    ((1, 9, 15, 8, 2), 7, 1, 1, 8, 64),      # G 18: fewer rows than lanes
    ((1, 15, 9, 4, 1), 7, 1, 2, 1, 40),      # G 40 rows: two per lane for the first 8
    ((2, 10, 10, 8, 2), 5, 2, 2, 8, 6),
]


@pytest.mark.parametrize("shape,k,sy,sx,xt,capacity", K4_CASES)
def test_k4_order_matches_reference(shape, k, sy, sx, xt, capacity):
    """The kernel's summation order against the plain K4 (another order of
    the same float32 products): within 1e-5 of max|dw|."""
    x, _, _ = _to_torch(*_inputs(shape, k, seed=8))
    B, Y, X, Z, _ = shape
    g = torch.from_numpy(np.random.RandomState(9).randn(B, 6, -(-Y // sy), -(-X // sx), Z).astype(np.float32))
    want = stem_conv.stem_wgrad_reference(x, g, k, sy, sx)
    got = k4_model(x, g, k, sy, sx, xt, capacity)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape,k,sy,sx,xt,capacity", [SHAPES[0] + (8, 5), SHAPES[2] + (4, 3), SHAPES[3] + (8, 2)])
def test_k4_order_matches_jax_vjp(shape, k, sy, sx, xt, capacity):
    """The kernel's summation order against JAX's dw: ``jax.grad`` through
    ``stem_conv3d``, whose custom VJP runs the wgrad kernel in interpret mode
    (it returns the banded dT; the VJP turns it into dw). 3e-4, as
    ``test_gradients_match_jax_vjp``."""
    x, w, b = _inputs(shape, k, seed=10)
    B, Y, X, Z, _ = shape
    g = np.random.RandomState(11).randn(B, -(-Y // sy), -(-X // sx), Z, 6).astype(np.float32)
    want = jax.grad(lambda w_: jnp.vdot(jstem(x, w_, b, sy, sx, True), g))(w)
    xt_, _, _ = _to_torch(x, w, b)
    got = k4_model(xt_, torch.from_numpy(np.moveaxis(g, -1, 1).copy()), k, sy, sx, xt, capacity)
    np.testing.assert_allclose(np.transpose(got.numpy(), (2, 3, 4, 1, 0)), np.asarray(want), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("B,Yo,Xo,xt,capacity", [
    (2, 7, 11, 8, 1000),   # fewer chunks (28) than the card's blocks: one each
    (2, 64, 64, 8, 16),    # 1,024 chunks, G 16 divides them
    (1, 2039, 7, 8, 264),  # 2,039 chunks (a prime), G 264: no multiple
])
def test_k4_visits_every_chunk_once(B, Yo, Xo, xt, capacity):
    """The port's schedule: G = min(chunks, capacity) blocks, none idle;
    over the grid every (b, yo, first xo) exactly once, each block's in the
    kernel's numbering order, the blocks' loads one apart at most."""
    n_chunks, grid = stem_conv_cuda.wgrad_grid(B, Yo, Xo, xt, capacity)
    assert n_chunks == B * Yo * -(-Xo // xt) and grid == min(n_chunks, capacity)
    order = [stem_conv_cuda.wgrad_chunks(i, grid, B, Yo, Xo, xt) for i in range(grid)]
    flat = [c for chunks in order for c in chunks]
    assert sorted(flat) == list(itertools.product(range(B), range(Yo), range(0, Xo, xt)))
    assert all(chunks and chunks == sorted(chunks) for chunks in order)
    assert [chunks[0] for chunks in order] == sorted(flat)[:grid]
    assert max(map(len, order)) - min(map(len, order)) <= 1


# --------------------------------------------------------------------- #
#  K3's schedule: tiles of (b, ty yo rows, tx xo columns, zt blocks of 4  #
#  z values) taken by a persistent grid, each staged with the zero-       #
#  padded input it reads (csrc/stem_conv.cu; stem_conv_cuda.fwd_plan,     #
#  fwd_tiles, fwd_thread, fwd_block_tiles)                                #
# --------------------------------------------------------------------- #

K3_CASES = [  # (B, cin, Y, X, Z), k, sy, sx, cout
    ((2, 1, 9, 11, 6), 3, 1, 1, 6),       # Z 6: 2 z blocks, the last half full; 11 columns in a tile
    ((1, 2, 13, 11, 6), 7, 2, 2, 6),      # odd Y/X at stride 2, cin 2
    ((2, 1, 7, 9, 5), 5, 1, 1, 18),       # Z 5, the 18-channel instance
    ((1, 2, 11, 13, 7), 5, 2, 2, 18),
    ((1, 1, 12, 10, 61), 3, 1, 1, 32),    # Z 61 (16 blocks, the last of 1 value), Xo 10 in tiles of 8
    ((1, 1, 6, 5, 150), 3, 1, 2, 8),      # 38 z blocks: two z tiles (32 + 6), stride (1, 2)
    ((2, 1, 13, 11, 64), 7, 2, 2, 18),    # the C1 stem's tile (16 z blocks x 8 columns)
    ((1, 2, 3, 300, 4), 7, 2, 2, 32),     # one z block: 128 columns would not fit, halved to 64
]


def _k3_plan(shape, k, sy, sx, cout):
    plan = stem_conv_cuda.fwd_plan(shape, k, sy, sx, cout)
    return plan, stem_conv_cuda.fwd_tiles(shape, k, sy, sx, plan)


@pytest.mark.parametrize("shape,k,sy,sx,cout", K3_CASES)
def test_k3_writes_every_output_once(shape, k, sy, sx, cout):
    """Over the persistent grid (``fwd_block_tiles`` of G = 5 blocks, or one
    per tile where there are fewer), each block's tiles (``fwd_tiles``) and
    each tile's threads (``fwd_thread``), every output (b, co, yo, xo, z) is
    written exactly once; a block has at most 256 threads, whole warps."""
    B, cin, Y, X, Z = shape
    Yo, Xo = -(-Y // sy), -(-X // sx)
    plan, tiles = _k3_plan(shape, k, sy, sx, cout)
    assert len(tiles) == plan["n_tiles"] and plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert plan["zt"] * plan["tx"] * plan["ty"] <= plan["threads"] and plan["smem"] <= stem_conv_cuda.SMEM_MAX
    grid = min(plan["n_tiles"], 5)
    count = np.zeros((B, cout, Yo, Xo, Z), np.int64)
    for tile in (i for blk in range(grid) for i in stem_conv_cuda.fwd_block_tiles(blk, grid, plan["n_tiles"])):
        b, (yo0, yo1), (xo0, xo1), (z0, z1), _ = tiles[tile]
        for t in range(plan["threads"]):
            zl, xl, yl = stem_conv_cuda.fwd_thread(t, plan)
            yo, xo, z = yo0 + yl, xo0 + xl, z0 + 4 * zl
            if yl >= plan["ty"] or yo >= yo1 or xo >= xo1 or z >= z1:  # the kernel's early return
                continue
            count[b, :, yo, xo, z:min(z + 4, Z)] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape,k,sy,sx,cout", K3_CASES)
def test_k3_window_covers_every_read(shape, k, sy, sx, cout):
    """Each block's staged tile (rows x cols x 4 nq values from its first
    input coordinate) holds every padded input its outputs read: rows
    yo * sy - p .. + k - 1, columns likewise, z - p .. z + p; and a thread's
    three float4s, from value 4 * its z block, lie in the row."""
    p = k // 2
    plan, tiles = _k3_plan(shape, k, sy, sx, cout)
    rows, cols, nz = plan["rows"], plan["cols"], 4 * plan["nq"]
    assert rows == (plan["ty"] - 1) * sy + k and cols == (plan["tx"] - 1) * sx + k
    assert 4 * (plan["zt"] - 1) + 12 <= nz
    for b, (yo0, yo1), (xo0, xo1), (z0, z1), (ylo, xlo, zlo) in tiles:
        assert ylo <= yo0 * sy - p and (yo1 - 1) * sy + p < ylo + rows
        assert xlo <= xo0 * sx - p and (xo1 - 1) * sx + p < xlo + cols
        assert zlo <= z0 - p and z1 - 1 + p < zlo + nz
        # a thread's strip: input z = 4 * zb - p + i, at row value 4 * zl + 4 - p + i, within its 12
        assert z0 - zlo == 4 and 0 <= 4 - p and 4 - p + 3 + k - 1 < 12


@pytest.mark.parametrize("n_tiles,capacity", [(7, 528), (4096, 528), (4096, 396), (2039, 264)])
def test_k3_blocks_take_every_tile_once(n_tiles, capacity):
    """K3's persistent grid: G = min(tiles, capacity) blocks, none idle;
    every tile taken once, each block's in increasing order, the blocks'
    counts one apart at most."""
    grid = min(n_tiles, capacity)
    order = [stem_conv_cuda.fwd_block_tiles(i, grid, n_tiles) for i in range(grid)]
    assert sorted(t for tiles in order for t in tiles) == list(range(n_tiles))
    assert all(tiles and tiles == sorted(tiles) for tiles in order)
    assert max(map(len, order)) - min(map(len, order)) <= 1


@pytest.mark.parametrize("item", [4, 2])
@pytest.mark.parametrize("shape,k,sy,sx,cout", [K3_CASES[0], K3_CASES[6], K3_CASES[7],
                                                ((8, 1, 128, 128, 64), 7, 2, 2, 18),
                                                ((2, 1, 128, 128, 64), 3, 1, 1, 18)])
def test_k3_shared_memory(shape, k, sy, sx, cout, item):
    """K3's shared memory: the float32 filter (channels rounded up to 4)
    and ``nbuf`` staged tiles of ``item``-byte values; two buffers only
    where two blocks of them fit on an SM, and at most what a block has."""
    plan = stem_conv_cuda.fwd_plan(shape, k, sy, sx, cout, item)
    cin = shape[1]
    tile = cin * plan["rows"] * plan["cols"] * 4 * plan["nq"] * item
    filt = cin * k**3 * plan["cs"] * 4
    assert plan["smem"] == filt + plan["nbuf"] * tile <= stem_conv_cuda.SMEM_MAX
    assert (plan["nbuf"] == 2) == (2 * (filt + 2 * tile + 1024) <= stem_conv_cuda.SM_SMEM)


def k3_model(x, w, b, sy, sx):
    """K3's output computed tile by tile as the kernel reads it: each
    block's staged tile (zeros outside x), then for output (yl, xl, 4 zl +
    e) of the tile the float32 sum over (ci, ky, kx, kz), in that order, of
    tile[ci, yl * sy + ky, xl * sx + kx, 4 zl + e + 4 - p + kz] times the
    filter; cast to x's dtype, then the bias added in that dtype."""
    B, cin, Y, X, Z = x.shape
    cout, k = w.shape[0], w.shape[-1]
    Yo, Xo = -(-Y // sy), -(-X // sx)
    p = k // 2
    plan, tiles = _k3_plan(tuple(x.shape), k, sy, sx, cout)  # the tiles in any order: each is written once
    rows, cols, nz, zt, tx, ty = plan["rows"], plan["cols"], 4 * plan["nq"], plan["zt"], plan["tx"], plan["ty"]
    m = max(rows, cols, nz)  # room for every tile past the edges
    xp = torch.nn.functional.pad(x.float(), (m, m, m, m, m, m))
    wf = w.float()
    acc = torch.empty((B, cout, Yo, Xo, Z))
    for bb, (yo0, yo1), (xo0, xo1), (z0, z1), (ylo, xlo, zlo) in tiles:
        tile = xp[bb, :, m + ylo:m + ylo + rows, m + xlo:m + xlo + cols, m + zlo:m + zlo + nz]
        s = torch.zeros((cout, ty, tx, 4 * zt))
        for ci in range(cin):
            for ky in range(k):
                for kx in range(k):
                    for kz in range(k):
                        v = tile[ci, ky:ky + sy * (ty - 1) + 1:sy, kx:kx + sx * (tx - 1) + 1:sx,
                                 4 - p + kz:4 - p + kz + 4 * zt]
                        s += v[None] * wf[:, ci, ky, kx, kz].view(cout, 1, 1, 1)
        acc[bb, :, yo0:yo1, xo0:xo1, z0:z1] = s[:, :yo1 - yo0, :xo1 - xo0, :z1 - z0]
    return acc.to(x.dtype) + b.to(x.dtype).view(1, cout, 1, 1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,sy,sx,cout", K3_CASES)
def test_k3_model_matches_reference(shape, k, sy, sx, cout, dtype):
    """The kernel's tiles and indexing against the plain K3: float32 within
    1e-5 of max|ref| (the same products summed in another order); bfloat16
    within 1e-2 (a sum near a rounding boundary lands one bf16 ulp apart),
    phase 3c's tolerances."""
    B, cin, Y, X, Z = shape
    rng = np.random.RandomState(12)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dt)
    w = torch.from_numpy((rng.randn(cout, cin, k, k, k) * 0.2).astype(np.float32)).to(dt)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(dt)
    want = stem_conv.stem_conv3d_reference(x, w, b, sy, sx)
    got = k3_model(x, w, b, sy, sx)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = (1e-5 if dtype == "float32" else 1e-2) * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape,k,sy,sx", [SHAPES[0], SHAPES[2], SHAPES[3]])
def test_k3_model_matches_jax_kernel(shape, k, sy, sx):
    """The kernel's tiles and indexing against JAX's stem kernel in
    interpret mode, float32, 2e-5 as ``test_forward_matches_jax_kernel``."""
    x, w, b = _inputs(shape, k, seed=13)
    want = np.asarray(jstem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), sy, sx, True))
    got = np.moveaxis(k3_model(*_to_torch(x, w, b), sy, sx).numpy(), 1, -1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
