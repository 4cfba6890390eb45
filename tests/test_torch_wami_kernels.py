"""The PyTorch WAMI kernels' wrappers against the JAX package's.

On the CPU a wrapper runs its kernel's plain version (the CUDA kernel
itself is held against that plain version on the card by
``chip_smoke.py``).  Inputs come from seeded numpy and feed both
packages.  Tolerance: the reference's ``_close`` —
max|Δ| / max(1, max|ref|) < 1e-5, and 1e-4 for the Hessian, whose sum
order differs; the change-detection mask is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wami_change_det as jcd
from repro.kernels import wami_debayer as jdeb
from repro.kernels import wami_gradient as jgrad
from repro.kernels import wami_grayscale as jgray
from repro.kernels import wami_steep as jsteep
from repro.kernels import wami_warp as jwarp
from repro_torch.apps.wami.cuda import DSE_P_AFFINE, PARITY_P_AFFINE
from repro_torch.apps.wami.knobs import WAMI_KNOB_TABLE
from repro_torch.core.knobs import powers_of_two
from repro_torch.kernels import wami_change_det as tcd
from repro_torch.kernels import wami_debayer as tdeb
from repro_torch.kernels import wami_gradient as tgrad
from repro_torch.kernels import wami_grayscale as tgray
from repro_torch.kernels import wami_steep as tsteep
from repro_torch.kernels import wami_warp as twarp

TILE = 128
KNOBS = [(1, 1), (4, 8), (16, 32)]          # (ports, unrolls)
SD_KNOBS = [(1, 1), (4, 8), (8, 16)]        # steep_descent: max_ports 8
# stages whose Table-1 knobs stop at 8 ports and 16 unrolls
SMALL_KNOB_STAGES = ("steep_descent", "warp", "warp_dse", "change_det")


def _close(a, b, tol=1e-5):
    fa, fb = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(fb).max()))
    assert float(np.abs(fa - fb).max()) / scale < tol


def _inputs(shape, seed=7):
    rng = np.random.default_rng(seed)
    H, W = shape
    return {
        "rgb": (rng.uniform(size=(H, W, 3)) * 255.0).astype(np.float32),
        "gray": (rng.uniform(size=(H, W)) * 255.0).astype(np.float32),
        "gx": rng.standard_normal((H, W)).astype(np.float32),
        "gy": rng.standard_normal((H, W)).astype(np.float32),
        "sd": rng.standard_normal((H, W, 6)).astype(np.float32),
        # drawn after the inputs above, which keep their values
        **_later_inputs(rng, H, W),
    }


def _later_inputs(rng, H, W):
    bayer = (rng.uniform(size=(H, W)) * 1023.0).astype(np.float32)
    img = (rng.uniform(size=(H, W)) * 255.0).astype(np.float32)
    noise = rng.standard_normal((H, W, 3)).astype(np.float32)
    return {
        "bayer": bayer,
        "img": img,
        "p": np.array(PARITY_P_AFFINE, np.float32),
        "p_dse": np.array(DSE_P_AFFINE, np.float32),
        "mu": img[..., None] + noise * np.float32(8.0),
        "var": np.full((H, W, 3), 36.0, np.float32),
        # unequal weights, with ties between the first two components in
        # every third row: the replaced component is the first weakest
        "w": _weights(rng, H, W),
    }


def _weights(rng, H, W):
    w = rng.uniform(0.05, 0.6, size=(H, W, 3)).astype(np.float32)
    w[::3, :, 1] = w[::3, :, 0]
    return w


# (name, port op, jax oracle, jax pallas op, input names, tolerance)
CASES = {
    "grayscale": (tgray.grayscale, jgray.grayscale_oracle, jgray.grayscale,
                  ("rgb",), 1e-5),
    "gradient": (tgrad.gradient, jgrad.gradient_oracle, jgrad.gradient,
                 ("gray",), 1e-5),
    "steep_descent": (tsteep.steepest_descent,
                      jsteep.steepest_descent_oracle,
                      jsteep.steepest_descent, ("gx", "gy"), 1e-5),
    "hessian": (tsteep.hessian, jsteep.hessian_oracle, jsteep.hessian,
                ("sd",), 1e-4),
    "debayer": (tdeb.debayer, jdeb.debayer_oracle, jdeb.debayer,
                ("bayer",), 1e-5),
    "warp": (twarp.warp_affine, jwarp.warp_affine_oracle, jwarp.warp_affine,
             ("img", "p"), 1e-5),
    "warp_dse": (twarp.warp_affine, jwarp.warp_affine_oracle,
                 jwarp.warp_affine, ("img", "p_dse"), 1e-5),
    "change_det": (tcd.change_detection, jcd.change_detection_oracle,
                   jcd.change_detection, ("img", "mu", "var", "w"), 1e-5),
}


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _check(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        if g.dtype == torch.bool:          # a mask: exactly equal
            assert np.asarray(w).dtype == np.bool_
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.numpy(), np.asarray(w), tol)


@pytest.mark.parametrize("name,ports,unrolls", [
    (n, p, u) for n in CASES
    for p, u in (SD_KNOBS if n in SMALL_KNOB_STAGES else KNOBS)])
def test_port_op_matches_jax_oracle_at_tile(name, ports, unrolls):
    op, oracle, _, args, tol = CASES[name]
    x = _inputs((TILE, TILE))
    got = op(*(torch.from_numpy(x[a]) for a in args), ports=ports,
             unrolls=unrolls)
    _check(got, oracle(*(jnp.asarray(x[a]) for a in args)), tol)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(set(CASES) - {"warp_dse"}))
def test_port_op_matches_jax_pallas_interpret(name):
    """The JAX Pallas kernel, run in interpret mode on the CPU, at a
    small shape with a knob point that splits both axes.  The warp runs
    at the small-shear p only: at the DSE's p some source coordinates
    are whole numbers, and the jitted JAX wrapper, which contracts the
    address arithmetic into FMAs, picks another floor() cell there than
    the JAX package's own plain version (the port follows the plain
    version, held against it at the DSE's p above)."""
    op, _, pallas_op, args, tol = CASES[name]
    x = _inputs((32, 64), seed=11)
    got = op(*(torch.from_numpy(x[a]) for a in args), ports=2, unrolls=8)
    want = pallas_op(*(jnp.asarray(x[a]) for a in args), ports=2,
                     unrolls=8, interpret=True)
    _check(got, want, tol)


def test_debayer_odd_block_matches_jax_oracle():
    """Blocks of 5 rows do not align to the 2x2 Bayer quad: the parity
    comes from global coordinates."""
    bayer = _inputs((30, 64), seed=13)["bayer"]
    got = tdeb.debayer(torch.from_numpy(bayer), ports=2, unrolls=5)
    _check(got, jdeb.debayer_oracle(jnp.asarray(bayer)), 1e-5)


@pytest.mark.slow
def test_debayer_odd_block_matches_jax_pallas_interpret():
    bayer = _inputs((30, 64), seed=13)["bayer"]
    got = tdeb.debayer(torch.from_numpy(bayer), ports=2, unrolls=5)
    _check(got, jdeb.debayer(jnp.asarray(bayer), ports=2, unrolls=5,
                             interpret=True), 1e-5)


def test_debayer_casts_an_integer_mosaic_to_float32():
    raw = (_inputs((32, 32))["bayer"]).astype(np.uint16).astype(np.int32)
    got = tdeb.debayer(torch.from_numpy(raw), ports=2, unrolls=4)
    assert got.dtype == torch.float32
    _check(got, jdeb.debayer_oracle(jnp.asarray(raw)), 1e-5)


def test_change_detection_mask_has_both_outcomes():
    """The parity inputs reach both sides of every discrete choice: a
    matched pixel, an unmatched one, and a low-weight match."""
    x = _inputs((TILE, TILE))
    mask, *_ = tcd.change_detection(
        *(torch.from_numpy(x[a]) for a in ("img", "mu", "var", "w")),
        ports=4, unrolls=8)
    share = float(mask.float().mean())
    assert 0.05 < share < 0.95


def test_parity_cases_cover_the_reference_stages():
    """``wami_cuda_parity_cases`` lists the reference's seven stage
    kernels, in its order, and each op agrees with its plain version."""
    from repro.apps.wami.pallas import wami_parity_cases
    from repro_torch.apps.wami.cuda import wami_cuda_parity_cases
    cases = wami_cuda_parity_cases(32, device="cpu")
    assert [c[0] for c in cases] == [c[0] for c in wami_parity_cases(32)]
    for name, op, oracle, args in cases:
        _check(op(*args, ports=2, unrolls=4), tuple(
            a.numpy() for a in _flat(oracle(*args))), 1e-5)


COST_MODELS = {
    "grayscale": ((tgray.vmem_bytes, jgray.vmem_bytes),
                  (tgray.grid_steps, jgray.grid_steps)),
    "gradient": ((tgrad.vmem_bytes, jgrad.vmem_bytes),
                 (tgrad.grid_steps, jgrad.grid_steps)),
    "steep_descent": ((tsteep.vmem_bytes, jsteep.vmem_bytes),
                      (tsteep.grid_steps, jsteep.grid_steps)),
    "hessian": ((tsteep.hessian_vmem_bytes, jsteep.hessian_vmem_bytes),
                (tsteep.grid_steps, jsteep.grid_steps)),
    "debayer": ((tdeb.vmem_bytes, jdeb.vmem_bytes),
                (tdeb.grid_steps, jdeb.grid_steps)),
    "warp": ((twarp.vmem_bytes, jwarp.vmem_bytes),
             (twarp.grid_steps, jwarp.grid_steps)),
    "change_det": ((tcd.vmem_bytes, jcd.vmem_bytes),
                   (tcd.grid_steps, jcd.grid_steps)),
}


@pytest.mark.parametrize("name", sorted(COST_MODELS))
def test_cost_models_equal_reference_over_table1(name):
    max_ports, max_unrolls = WAMI_KNOB_TABLE[name]
    n = 0
    for H, W in ((TILE, TILE), (512, 512)):
        for ports in powers_of_two(1, max_ports):
            for unrolls in range(1, max_unrolls + 1):
                for port_fn, ref_fn in COST_MODELS[name]:
                    assert (port_fn(H, W, ports=ports, unrolls=unrolls)
                            == ref_fn(H, W, ports=ports, unrolls=unrolls))
                    n += 1
    assert n > 0


def test_cpu_tensors_never_launch_a_kernel():
    kernels = (tgray.grayscale_kernel, tgrad.gradient_kernel,
               tsteep.steepest_descent_kernel, tsteep.hessian_kernel,
               tdeb.debayer_kernel, twarp.warp_kernel,
               tcd.change_det_kernel)
    before = [k.launches for k in kernels]
    x = {k: torch.from_numpy(v) for k, v in _inputs((32, 32)).items()}
    tgray.grayscale(x["rgb"], ports=2, unrolls=4)
    tgrad.gradient(x["gray"], ports=2, unrolls=4)
    tsteep.steepest_descent(x["gx"], x["gy"], ports=2, unrolls=4)
    tsteep.hessian(x["sd"], ports=2, unrolls=4)
    tdeb.debayer(x["bayer"], ports=2, unrolls=4)
    twarp.warp_affine(x["img"], x["p"], ports=2, unrolls=4)
    tcd.change_detection(x["img"], x["mu"], x["var"], x["w"], ports=2,
                         unrolls=4)
    assert [k.launches for k in kernels] == before == [0] * 7


@pytest.mark.parametrize("ports,unrolls", [(3, 4), (2, 5), (0, 4)])
def test_non_dividing_knobs_raise(ports, unrolls):
    gray = torch.zeros((32, 32))
    with pytest.raises(ValueError):
        tgrad.gradient(gray, ports=ports, unrolls=unrolls)


def test_hessian_plain_version_is_symmetric_and_knob_free():
    sd = torch.from_numpy(_inputs((TILE, TILE))["sd"])
    outs = [tsteep.hessian(sd, ports=p, unrolls=u)
            for p, u in ((1, 32), (2, 4), (16, 1))]
    for o in outs[1:]:
        _close(o.numpy(), outs[0].numpy(), 1e-4)
    _close(outs[0].numpy(), outs[0].numpy().T, 1e-4)


def test_hessian_scratch_covers_every_table1_grid_and_grows():
    """The Hessian's cached partials have a row per CTA of every grid
    ``launch_grid`` gives over its Table-1 knobs, grow only when a grid
    outgrows them, and keep one zeroed ticket counter."""
    from repro_torch.kernels.wami_common import launch_grid
    from repro_torch.kernels.wami_steep.kernel import HessianScratch
    scratch = HessianScratch()
    max_ports, max_unrolls = WAMI_KNOB_TABLE["hessian"]
    most, ticket0 = 0, None
    for n in (TILE, 512):
        for ports in powers_of_two(1, max_ports):
            for unrolls in range(1, max_unrolls + 1):
                if n % unrolls:
                    continue
                rows, cols = launch_grid(n, n, ports=ports, unrolls=unrolls)
                before = scratch.get("cpu", 0)[0]
                partials, ticket = scratch.get("cpu", rows * cols)
                assert partials.shape[1] == 36
                assert partials.shape[0] >= rows * cols
                assert (partials is before) == (rows * cols <= most)
                most = max(most, rows * cols)
                assert partials.shape[0] == most
                ticket0 = ticket0 if ticket0 is not None else ticket
                assert ticket is ticket0 and int(ticket) == 0
    assert most == 512 * 16


def test_change_det_launch_geometry_at_every_table1_point():
    """A thread takes a run of 4 pixels, a CTA up to 1,024 threads: one
    pass over every Table-1 tile of the 128 x 128 frame, at most two at
    512 x 512 (ports 1, unrolls 16 has 2,048 runs); and a frame whose
    width is not a multiple of 4 runs one scalar pixel a thread."""
    from repro_torch.kernels.wami_change_det.kernel import \
        change_det_geometry
    max_ports, max_unrolls = WAMI_KNOB_TABLE["change_det"]
    passes = {}
    for n in (TILE, 512):
        for ports in range(1, max_ports + 1):
            for unrolls in range(1, max_unrolls + 1):
                if n % ports or n % unrolls:
                    continue
                threads, p = change_det_geometry(n, n, ports=ports,
                                                 unrolls=unrolls)
                assert threads <= 1024 and threads % 32 == 0
                runs = unrolls * (n // ports) // 4
                assert threads == min(1024, -(-runs // 32) * 32)
                passes[n] = max(passes.get(n, 0), p)
    assert passes == {TILE: 1, 512: 2}
    assert change_det_geometry(512, 512, ports=1, unrolls=16) == (1024, 2)
    # W % 4 != 0: every pixel scalar; bw % 4 != 0: a scalar head or tail
    assert change_det_geometry(30, 66, ports=11, unrolls=5) == (32, 1)
    assert change_det_geometry(32, 72, ports=8, unrolls=4) == (32, 1)


@pytest.mark.parametrize("stage,geometry", [
    ("debayer", tdeb.kernel.debayer_geometry),
    ("gradient", tgrad.kernel.gradient_geometry)])
def test_debayer_gradient_launch_geometry_at_every_table1_point(stage,
                                                                geometry):
    """Debayer and gradient take a run of 4 pixels a thread, up to 1,024
    threads a CTA (debayer: one pixel a thread in tiles of at most 256):
    one pass over every Table-1 tile of the 128 x 128 frame (at most
    4,096 pixels), at most four at 512 x 512 (ports 1, unrolls 32 has
    4,096 runs); a frame whose width is not a multiple of 4 runs one
    scalar pixel a thread, and a tile off the 16-byte grid adds a scalar
    head or tail."""
    max_ports, max_unrolls = WAMI_KNOB_TABLE[stage]
    assert (max_ports, max_unrolls) == (16, 32)
    passes = {}
    for n in (TILE, 512):
        for ports in range(1, max_ports + 1):
            for unrolls in range(1, max_unrolls + 1):
                if n % ports or n % unrolls:
                    continue
                threads, p = geometry(n, n, ports=ports, unrolls=unrolls)
                assert threads <= 1024 and threads % 32 == 0
                pixels = unrolls * (n // ports)
                items = (pixels if stage == "debayer" and pixels <= 256
                         else pixels // 4)
                assert threads == min(1024, -(-items // 32) * 32)
                passes[n] = max(passes.get(n, 0), p)
    assert passes == {TILE: 1, 512: 4}
    assert geometry(512, 512, ports=1, unrolls=32) == (1024, 4)
    assert geometry(TILE, TILE, ports=1, unrolls=32) == (1024, 1)
    # W % 4 != 0: every pixel scalar (30 pixels of a 6-column tile)
    assert geometry(30, 66, ports=11, unrolls=5) == (32, 1)
    # 9-column tiles at 72 (36 pixels: one a thread in debayer; else runs
    # of 4 between a scalar head and tail)
    assert geometry(32, 72, ports=8, unrolls=4) == (
        (64, 1) if stage == "debayer" else (32, 1))
    # 160 pixels: one a thread in debayer, 40 runs in gradient
    assert geometry(30, 64, ports=2, unrolls=5) == (
        (160, 1) if stage == "debayer" else (64, 1))


@pytest.mark.parametrize("stage,geometry", [
    ("grayscale", tgray.kernel.grayscale_geometry),
    ("steep_descent", tsteep.kernel.steepest_descent_geometry)])
def test_grayscale_steep_launch_geometry_at_every_table1_point(stage,
                                                               geometry):
    """Grayscale and steepest descent take a run of 4 pixels a thread, up
    to 1,024 threads a CTA, and one pixel a thread in tiles of at most 256
    (grayscale) or 128 pixels (steepest descent): one pass over every
    Table-1 tile of the 128 x 128 frame, at most four (grayscale, ports 1
    and unrolls 32: 4,096 runs) or two (steepest descent, ports 1 and
    unrolls 16: 2,048 runs) at 512 x 512; a frame whose width is not a
    multiple of 4 runs one scalar pixel a thread, and a tile off the
    16-byte grid adds a scalar head or tail."""
    max_ports, max_unrolls = WAMI_KNOB_TABLE[stage]
    one_a_thread = {"grayscale": 256, "steep_descent": 128}[stage]
    passes = {}
    for n in (TILE, 512):
        for ports in range(1, max_ports + 1):
            for unrolls in range(1, max_unrolls + 1):
                if n % ports or n % unrolls:
                    continue
                threads, p = geometry(n, n, ports=ports, unrolls=unrolls)
                assert threads <= 1024 and threads % 32 == 0
                pixels = unrolls * (n // ports)
                items = pixels if pixels <= one_a_thread else pixels // 4
                assert threads == min(1024, -(-items // 32) * 32)
                passes[n] = max(passes.get(n, 0), p)
    most = {"grayscale": 4, "steep_descent": 2}[stage]
    assert passes == {TILE: 1, 512: most}
    assert geometry(512, 512, ports=1, unrolls=max_unrolls) == (1024, most)
    # the largest tile of the 128 frame: 1,024 runs (grayscale), 512
    assert geometry(TILE, TILE, ports=1, unrolls=max_unrolls) == (
        TILE * max_unrolls // 4, 1)
    # W % 4 != 0: every pixel scalar (30 pixels of a 6-column tile; 495
    # of a 33-column tile, above the one-pixel-a-thread limit)
    assert geometry(30, 66, ports=11, unrolls=5) == (32, 1)
    assert geometry(30, 66, ports=2, unrolls=15) == (512, 1)
    # 18- and 9-column tiles at 72, 288 pixels: runs of 4 between a
    # scalar head and tail (a 9-column tile at column 9: a head of 3, one
    # run, a tail of 2 -- six items a row); 144 pixels: one a thread in
    # grayscale, runs (six items a row) in steepest descent
    assert geometry(32, 72, ports=4, unrolls=16) == (96, 1)
    assert geometry(32, 72, ports=8, unrolls=32) == (192, 1)
    assert geometry(32, 72, ports=4, unrolls=8) == (
        (160, 1) if stage == "grayscale" else (64, 1))
    # 160 pixels: one a thread in grayscale, 40 runs in steepest descent;
    # 48: one a thread; 320: 80 runs
    assert geometry(30, 64, ports=2, unrolls=5) == (
        (160, 1) if stage == "grayscale" else (64, 1))
    assert geometry(30, 64, ports=4, unrolls=3) == (64, 1)
    assert geometry(30, 64, ports=1, unrolls=5) == (96, 1)


def test_warp_launch_geometry_at_every_table1_point():
    """The warp takes a thread a pixel in tiles of at most 1,024 pixels
    and a thread per run of 4 output pixels (16 gathers in flight) in
    larger ones, up to 1,024 threads a CTA either way: one pass over
    every Table-1 tile of the 128 x 128 frame, at most two at 512 x 512
    (ports 1, unrolls 16: 2,048 runs); a frame whose width is not a
    multiple of 4 runs one scalar pixel a thread, and a tile off the
    16-byte grid adds a scalar head or tail."""
    geometry = twarp.kernel.warp_geometry
    max_ports, max_unrolls = WAMI_KNOB_TABLE["warp"]
    assert (max_ports, max_unrolls) == (8, 16)
    passes = {}
    for n in (TILE, 512):
        for ports in range(1, max_ports + 1):
            for unrolls in range(1, max_unrolls + 1):
                if n % ports or n % unrolls:
                    continue
                threads, p = geometry(n, n, ports=ports, unrolls=unrolls)
                assert threads <= 1024 and threads % 32 == 0
                pixels = unrolls * (n // ports)
                items = pixels if pixels <= 1024 else pixels // 4
                assert threads == min(1024, -(-items // 32) * 32)
                passes[n] = max(passes.get(n, 0), p)
    assert passes == {TILE: 1, 512: 2}
    assert geometry(512, 512, ports=1, unrolls=16) == (1024, 2)
    # the DSE's default (1, 8) at tile 128: 1,024 pixels, a thread each
    assert geometry(TILE, TILE, ports=1, unrolls=8) == (1024, 1)
    # 2,048 pixels: 512 runs
    assert geometry(TILE, TILE, ports=1, unrolls=16) == (512, 1)
    # W % 4 != 0: every pixel scalar (30 pixels of a 6-column tile; 495
    # of a 33-column tile)
    assert geometry(30, 66, ports=11, unrolls=5) == (32, 1)
    assert geometry(30, 66, ports=2, unrolls=15) == (512, 1)
    # above 1,024 pixels: every pixel scalar where W % 4 != 0 (1,980
    # pixels, two passes); whole runs (480); 18-column tiles at 72, off
    # the 16-byte grid, run 4 runs between a head and a tail of 2 (six
    # items a row, 64 rows); at most 1,024 pixels, a thread a pixel
    assert geometry(30, 66, ports=1, unrolls=30) == (1024, 2)
    assert geometry(30, 64, ports=1, unrolls=30) == (480, 1)
    assert geometry(64, 72, ports=4, unrolls=64) == (384, 1)
    assert geometry(32, 72, ports=4, unrolls=16) == (288, 1)
    assert geometry(30, 64, ports=1, unrolls=5) == (320, 1)


@pytest.mark.parametrize("package,source", [
    (tgray, "wami_grayscale"), (twarp, "wami_warp")])
def test_scalar_pixel_limit_matches_the_c_source(package, source):
    """The Python mirror's one-pixel-a-thread limit is the kernel's
    ``kScalarPixels`` (the C source is parsed; it cannot be compiled
    here)."""
    import os
    import re
    from repro_torch.kernels.build import CSRC_DIR
    with open(os.path.join(CSRC_DIR, f"{source}.cu")) as f:
        m = re.search(r"constexpr int kScalarPixels = (\d+);", f.read())
    assert m and int(m.group(1)) == package.kernel.SCALAR_PIXELS


def test_grayscale_plain_version_is_the_kernels_float32_arithmetic():
    """The plain version's luma is float32 products by the float32
    constants, summed left to right and rounded at each step: the
    arithmetic of the CUDA kernel (no product contracted into an FMA),
    so the two agree bit for bit."""
    rgb = _inputs((32, 40))["rgb"]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    want = ((np.float32(0.299) * r + np.float32(0.587) * g)
            + np.float32(0.114) * b)
    assert want.dtype == np.float32
    got = tgray.grayscale(torch.from_numpy(rgb), ports=4, unrolls=8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", [
    tgray.grayscale_kernel, tgrad.gradient_kernel,
    tsteep.steepest_descent_kernel, tsteep.hessian_kernel,
    tdeb.debayer_kernel, twarp.warp_kernel, tcd.change_det_kernel],
    ids=lambda k: k.symbol)
def test_binding_matches_the_c_entry_point(kernel):
    """Each ctypes binding declares one argtype per parameter of its
    exported C function, pointers as c_void_p and ints as c_int (the C
    source is parsed; it cannot be compiled here)."""
    import ctypes
    import os
    import re
    from repro_torch.kernels.build import CSRC_DIR, SOURCES
    assert kernel.library in SOURCES
    with open(os.path.join(CSRC_DIR, f"{kernel.library}.cu")) as f:
        src = f.read()
    m = re.search(r"WAMI_EXPORT int " + kernel.symbol + r"\(([^)]*)\)", src)
    assert m, f"{kernel.symbol} not exported by {kernel.library}.cu"
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_int if p.startswith("int ") else ctypes.c_void_p
            for p in params]
    assert all(p.startswith("int ") or "*" in p for p in params), params
    assert kernel.argtypes == want
