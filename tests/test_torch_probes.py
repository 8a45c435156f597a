"""The probes P1-P5 of the port against the scripts' own Pallas kernels, on
the CPU.

``scripts/probe_pallas_int8.py`` runs its TPU loop when imported and both
scripts set the persistent compile cache, so the kernel bodies (``k_dot``,
``k_dotb``, ``k_dot3``, ``make_kernel``, ``make_kernel_flat``) are taken out
of the scripts' syntax trees and executed with small shape constants (4
frames of 6x6, 48 rows a padded frame so that at least W + 1 are pad, C=128,
P=32), then run through ``pl.pallas_call(..., interpret=True)`` with the
scripts' BlockSpecs. Inputs are seeded numpy draws from the scripts'
distributions, made by the port's probe entry points; the port's wrappers,
given CPU tensors, run their plain versions.

Tolerances:
* P1, P2, P3: exact (s32 sums; bf16 products of integers whose partial sums
  stay below 2**24 are exact in f32).
* P4, P5: every spec that computes the full block (``full``, ``dot2d``,
  ``hwpad``, ``im2col``) equals the port's plain version of ``full``
  exactly, and so does P5 rebuilt from K2's tile plan in its flat layout. Against the interpreted kernel each variant may differ by one
  int8 step on at most 0.1% of the elements: the kernel is compiled by XLA,
  which contracts ``acc * a + b + x * 0.01`` into FMAs where the port rounds
  each operation, the rule of ``tests/test_torch_fused_bottleneck.py``.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.torch_threads import one_torch_thread  # noqa: F401 - autouse
from tubedetr_tpu_torch.ops import _cuda_build
from tubedetr_tpu_torch.ops.fused_bottleneck import TilePlan
from tubedetr_tpu_torch.ops.probe_bottleneck import (
    FLAT_VARIANTS,
    bottleneck_variant,
    flat_bottleneck,
    flat_bottleneck_plain,
    probe_fold,
)
from tubedetr_tpu_torch.ops.probe_mm import bf16_mm, int8_mm, int8_mm_frames
from tubedetr_tpu_torch.probes import fused_variants as fv
from tubedetr_tpu_torch.probes import int8_matmul as im
from tubedetr_tpu_torch.probes import mm_ablations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W, HWP, C, P = 4, 6, 6, 48, 128, 32
HW = H * W
NN = 64  # the matmul probes' output channels
# (a, b) of the three stages: the script's, and one that spreads q1, q2 and
# the output over [0, 127] at these small widths
FOLDS = {
    "script": ((1e-4, 1e-4, 1e-4), (0.0, 0.0, 0.0)),
    "wide": ((1.5e-3, 1.5e-3, 4e-3), (0.5, -2.0, 1.25)),
}


def script_functions(name, wanted, **consts):
    """The named functions of ``scripts/<name>``, compiled from its syntax
    tree in a namespace holding ``jax``, ``jnp`` and ``consts``; nothing else
    of the script runs."""
    path = os.path.join(ROOT, "scripts", name)
    tree = ast.parse(open(path).read(), filename=path)
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert sorted(f.name for f in fns) == sorted(wanted)
    ns = {"jax": jax, "jnp": jnp, **consts}
    exec(compile(ast.Module(body=fns, type_ignores=[]), path, "exec"), ns)
    return ns


def vmem_block(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


# ---------------------------------------------------------------- P1-P3


def matmul_inputs():
    x, wt = im.make_inputs(np.random.RandomState(0), N, HW, C, NN, device="cpu")
    return x, wt, x.numpy(), np.ascontiguousarray(wt.numpy().T)


def script_matmul(body, x, w, f, out_dtype):
    """``pl_dot`` / ``pl_dotb`` of the script: blocks of f*HW flat rows."""
    m = f * HW
    return np.asarray(pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((x.shape[0], w.shape[1]), out_dtype),
        grid=(x.shape[0] // m,),
        in_specs=[vmem_block((m, x.shape[1]), lambda i: (i, 0)),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=vmem_block((m, w.shape[1]), lambda i: (i, 0)),
        interpret=True,
    )(x, w))


@pytest.mark.parametrize("f", [2, 4])
def test_p1_int8_mm_matches_the_script_kernel(f):
    body = script_functions("probe_pallas_int8.py", {"k_dot"})["k_dot"]
    x, wt, xn, wn = matmul_inputs()
    want = script_matmul(body, jnp.asarray(xn), jnp.asarray(wn), f, jnp.int32)
    before = int8_mm.launches
    got = int8_mm(x, wt)
    assert int8_mm.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("f", [2, 4])
def test_p2_bf16_mm_matches_the_script_kernel(f):
    body = script_functions("probe_pallas_int8.py", {"k_dotb"})["k_dotb"]
    x, wt, xn, wn = matmul_inputs()
    want = script_matmul(body, jnp.asarray(xn).astype(jnp.bfloat16),
                         jnp.asarray(wn).astype(jnp.bfloat16), f, jnp.float32)
    got = bf16_mm(x.to(torch.bfloat16), wt.to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("f", [2, 4])
def test_p3_int8_mm_frames_matches_the_script_kernel(f):
    body = script_functions("probe_pallas_int8.py", {"k_dot3"})["k_dot3"]
    x, wt, xn, wn = matmul_inputs()
    x3 = xn.reshape(N, HW, C)
    want = np.asarray(pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((N, HW, NN), jnp.int32),
        grid=(N // f,),
        in_specs=[vmem_block((f, HW, C), lambda i: (i, 0, 0)),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=vmem_block((f, HW, NN), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(x3), jnp.asarray(wn)))
    got = int8_mm_frames(x.view(N, HW, C), wt)
    assert got.shape == (N, HW, NN)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.reshape(N * HW, NN).numpy(), int8_mm(x, wt).numpy())


# ---------------------------------------------------------------- P4, P5


def bottleneck_inputs(flat, fold_name):
    """The port's probe inputs (the script's draws) with the fold
    ``fold_name``, and the same arrays for the script's kernel."""
    x, raw = fv.make_inputs(flat, N, H, W, C, P, HWP, device="cpu")
    a, b = FOLDS[fold_name]
    w1 = raw.w1.t().numpy()  # back to the script's (C, P), (9, P_in, P_out), (P, C)
    w2 = raw.w2.transpose(1, 2).numpy()
    w3 = raw.w3.t().numpy()
    fold = probe_fold(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (w1, w2, w3)), a, b)
    vecs = []
    for stage, width in enumerate((P, P, C)):
        vecs += [jnp.full((1, width), a[stage], jnp.float32), jnp.full((1, width), b[stage], jnp.float32)]
    jargs = [jnp.asarray(x.numpy()), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3), *vecs]
    return x, fold, jargs


def script_bottleneck(variant, f, jargs, flat):
    """``run`` / ``run_flat`` of the script: its kernel, its BlockSpecs."""
    ns = script_functions("probe_fused_variants.py", {"make_kernel", "make_kernel_flat"},
                          N=N, H=H, W=W, HW=HW, HWP=HWP, C=C, P=P)
    rows, off = (HWP if flat else HW), W + 1
    scratch = (f * HWP + 2 * off, P) if flat else (f, HW + 2 * off, P)
    return np.asarray(pl.pallas_call(
        ns["make_kernel_flat" if flat else "make_kernel"](variant, f),
        out_shape=jax.ShapeDtypeStruct((N, rows, C), jnp.int8),
        grid=(N // f,),
        in_specs=[vmem_block((f, rows, C), lambda i: (i, 0, 0))]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 9,
        out_specs=vmem_block((f, rows, C), lambda i: (i, 0, 0)),
        scratch_shapes=[pltpu.VMEM(scratch, jnp.int8)],
        interpret=True,
    )(*jargs))


def assert_within_one_step(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("fold_name", list(FOLDS))
@pytest.mark.parametrize("spec", ["full:2", "noshift:2", "dot2d:2", "convonly:2", "noshift:4",
                                  "hwpad:2", "im2col:2"])
def test_p4_p5_match_the_script_kernel(spec, fold_name):
    variant, f = fv.parse_spec(spec)
    flat = variant in FLAT_VARIANTS
    x, fold, jargs = bottleneck_inputs(flat, fold_name)
    want = script_bottleneck(variant, f, jargs, flat)
    before = (bottleneck_variant.launches, flat_bottleneck.launches)
    got = fv.variant_call(variant, x, fold, H, W)()
    assert (bottleneck_variant.launches, flat_bottleneck.launches) == before
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), fv.plain_call(variant, x, fold, H, W)().numpy())
    assert_within_one_step(got.numpy(), want)
    if flat:
        assert not got[:, HW:].any()  # pad rows come out 0
    if fv.KERNEL[variant] in ("full", "hwpad", "im2col"):  # the full block's function
        full = fv.variant_call("full", x[:, :HW].contiguous(), fold, H, W)()
        np.testing.assert_array_equal(got[:, :HW].numpy(), full.numpy())
    if fold_name == "wide":  # the inputs reach every part of the int8 range
        assert 0.05 < (got[:, :HW] == 0).float().mean() < 0.7
        assert (got[:, :HW] == 127).any() and ((got > 0) & (got < 127)).float().mean() > 0.2


@pytest.mark.parametrize("fold_name,tiles", [("script", 1), ("wide", 2)])
@pytest.mark.parametrize("variant", FLAT_VARIANTS)
def test_flat_layout_on_k2s_plan_matches_the_script(variant, fold_name, tiles):
    """P5 as the card runs it, K2's kernel in its flat layout, rebuilt band
    by band from K2's plan (``tiled_block`` with ``hw``: flat rows into the
    q1 grid, pad rows dropped there and written 0 in the output; im2col as
    one K=9P product over the patch) at the probe tests' shapes: 4 frames of
    6x6 in 48 rows, bands of 64 or 128 positions that cross frames. Equal to
    the plain version; within one int8 step of the script's
    ``make_kernel_flat`` in interpret mode on at most 0.1% of the elements."""
    from tests.test_torch_fused_bottleneck import tiled_block

    x, fold, jargs = bottleneck_inputs(True, fold_name)
    plan = TilePlan(W, P, 1, 2, tiles, im2col=variant == "im2col")
    got = tiled_block(x, fold, 1, plan, "im2col" if variant == "im2col" else "full", hw=(H, W))
    np.testing.assert_array_equal(got.numpy(), flat_bottleneck_plain(x, fold, H, W).numpy())
    assert_within_one_step(got.numpy(), script_bottleneck(variant, 2, jargs, True))
    assert not got[:, HW:].any() and bool(x[:, HW:].ne(0).any())  # pad rows in: random; out: 0


@pytest.mark.parametrize("variant", ["noshift", "convonly"])
def test_noshift_and_convonly_match_numpy(variant):
    """An independent numpy reference: noshift is conv1, then q1 times the sum
    of the nine taps, then conv3; convonly is conv3 on q1; f32 epilogues in
    the script's order, each operation rounded."""
    x, fold, _ = bottleneck_inputs(False, "wide")
    (a1, a2, a3), (b1, b2, b3) = (tuple(np.float32(v) for v in t) for t in FOLDS["wide"])

    def requant(y):
        return np.clip(np.round(np.maximum(y, np.float32(0))), 0, 127).astype(np.int64)

    rows = x.numpy().reshape(-1, C).astype(np.int64)
    q1 = requant((rows @ fold.w1.numpy().T.astype(np.int64)).astype(np.float32) * a1 + b1)
    q2 = q1
    if variant == "noshift":
        taps = fold.w2.numpy().astype(np.int64).sum(0).T  # [in][out]
        q2 = requant((q1 @ taps).astype(np.float32) * a2 + b2)
    acc3 = (q2 @ fold.w3.numpy().T.astype(np.int64)).astype(np.float32)
    want = requant(acc3 * a3 + b3 + rows.astype(np.float32) * np.float32(0.01))
    got = fv.variant_call(variant, x, fold, H, W)()
    np.testing.assert_array_equal(got.numpy().reshape(-1, C), want)
    assert not torch.equal(got, fv.variant_call("full", x, fold, H, W)())


# ---------------------------------------------------------------- wrappers and entry points


def test_wrappers_reject_bad_input():
    x, wt = im.make_inputs(np.random.RandomState(0), 2, 8, 64, 64, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        int8_mm(x.float(), wt)
    with pytest.raises(ValueError, match="bfloat16"):
        bf16_mm(x, wt)
    with pytest.raises(ValueError, match="K"):
        int8_mm(x[:, :32], wt)
    with pytest.raises(ValueError, match="3-D"):
        int8_mm_frames(x, wt)
    with pytest.raises(ValueError, match="device"):
        int8_mm(x.to("meta"), wt.to("meta"))
    xb, fold = fv.make_inputs(False, 1, 4, 4, 128, 32, device="cpu")
    x4 = xb.view(1, 4, 4, 128)
    with pytest.raises(ValueError, match="unknown variant"):
        bottleneck_variant(x4, fold, "dot2d")
    with pytest.raises(ValueError, match="int8"):
        bottleneck_variant(x4[..., :64], fold, "full")
    with pytest.raises(ValueError, match="int8"):
        bottleneck_variant(x4.float(), fold, "noshift")
    with pytest.raises(ValueError, match="device"):
        bottleneck_variant(x4.to("meta"), fold, "full")
    xf, ffold = fv.make_inputs(True, 1, 4, 4, 128, 32, hwp=20, device="cpu")
    with pytest.raises(ValueError, match="pad rows"):  # 4 pad rows, a 4x4 frame needs 5
        flat_bottleneck(xf, ffold, "hwpad", 4, 4)
    with pytest.raises(ValueError, match="unknown variant"):
        flat_bottleneck(xf, ffold, "full", 4, 4)
    with pytest.raises(ValueError, match="int8"):
        flat_bottleneck(xf[..., :64], ffold, "im2col", 4, 4)
    assert flat_bottleneck(xf[:, :16].contiguous(), ffold, "im2col", 2, 4)[:, 8:].eq(0).all()
    with pytest.raises(ValueError, match="device"):
        flat_bottleneck(torch.zeros(1, 24, 128, dtype=torch.int8, device="meta"),
                        ffold, "hwpad", 4, 4)


@pytest.mark.parametrize("spec", ["full", "full:", "full:0", "conv:2", "hwpad:x"])
def test_bad_specs_are_refused(spec):
    with pytest.raises(ValueError, match="variant:F"):
        fv.parse_spec(spec)


def test_entry_points_on_the_cpu():
    """The entry points' control flow at a small size on the CPU (untimed):
    the script's default specs, F printed, repeated kernels named; without a
    card, ``main`` raises before it prints anything."""
    lines = []
    recs = fv.run(list(fv.DEFAULT_SPECS) + ["hwpad:2", "im2col:2"], device="cpu",
                  n=N, h=H, w=W, c=C, p=P, hwp=HWP, out=lines.append)
    assert [r["spec"] for r in recs] == list(fv.DEFAULT_SPECS) + ["hwpad:2", "im2col:2"]
    assert {r["spec"]: r["same_kernel_as"] for r in recs if r["same_kernel_as"]} == {
        "dot2d:2": "full:2", "noshift:8": "noshift:2"}
    assert all(f"F={r['F']}" in line for r, line in zip(recs, lines))
    assert recs[0]["ops"] == 2 * N * HW * (C * P + 9 * P * P + P * C)
    recs = im.run(device="cpu", n_frames=N, hw=HW, k=C, n=NN, frames_per_step=(2, 4),
                  out=lines.append)
    assert [(r["probe"], r["F"]) for r in recs] == [
        (p, f) for f in (2, 4) for p in ("library", "P1", "P2", "P3")]
    for main in (im.main, lambda: fv.main([])):
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            main()


def test_a_changed_header_makes_every_library_stale(tmp_path, monkeypatch):
    """The kernels include ``csrc/*.cuh`` by name, so a header newer than a
    built library marks that library for a rebuild."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda_build, "BUILD", str(build))
    for path, mtime in ((csrc / "k.cu", 100), (csrc / "tiles.cuh", 100), (build / "libk.so", 200)):
        path.write_text("")
        os.utime(path, (mtime, mtime))
    assert _cuda_build.sources() == ["k"]
    assert not _cuda_build._stale("k")
    os.utime(csrc / "tiles.cuh", (300, 300))
    assert _cuda_build._stale("k")
    os.utime(build / "libk.so", (400, 400))
    os.utime(csrc / "k.cu", (500, 500))
    assert _cuda_build._stale("k")
    (build / "libk.so").unlink()
    assert _cuda_build._stale("k")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120probe_mm_bf16_kernelE14CUtensorMap_stS0_PfNS_5ShapeE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120probe_mm_bf16_kernelE14CUtensorMap_stS0_PfNS_5ShapeE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 164.962 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118probe_mm_s8_kernelE14CUtensorMap_stS0_PiNS_5ShapeE' for 'sm_90a'
ptxas info    : (C7508) Potential Performance Loss: setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_118probe_mm_s8_kernelE14CUtensorMap_stS0_PiNS_5ShapeE
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 2048 bytes smem, 912 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_entry(tmp_path, monkeypatch):
    """The ``-Xptxas -v`` log is read per kernel entry: registers, stack,
    spills and static shared memory from that entry's own lines (not from a
    device function's properties), and the numbered notes printed while it
    was compiled. A library never built has an empty log."""
    usage = _cuda_build.ptxas_usage(PTXAS_LOG)
    bf16, s8 = (next(v for k, v in usage.items() if name in k)
                for name in ("probe_mm_bf16_kernel", "probe_mm_s8_kernel"))
    assert len(usage) == 2
    assert bf16 == {"registers": 168, "stack_bytes": 0, "spill_store_bytes": 0,
                    "spill_load_bytes": 0, "smem_bytes": 0, "notes": []}
    assert s8["registers"] == 96 and s8["smem_bytes"] == 2048
    assert (s8["stack_bytes"], s8["spill_store_bytes"], s8["spill_load_bytes"]) == (16, 12, 20)
    assert len(s8["notes"]) == 1 and "setmaxnreg ignored" in s8["notes"][0]
    monkeypatch.setattr(_cuda_build, "BUILD", str(tmp_path))
    assert _cuda_build.build_log("probe_mm") == ""
    (tmp_path / "libprobe_mm.log").write_text(PTXAS_LOG)
    assert _cuda_build.build_log("probe_mm") == PTXAS_LOG


@pytest.mark.parametrize("name", list(mm_ablations.ABLATIONS))
def test_mm_ablations_apply_to_the_sources(name):
    """Each ablation of P1-P3's kernel is one set of edits to the current
    ``probe_mm.cu`` and headers, each edit matching exactly once; ``base``
    is the sources as they are."""
    base = mm_ablations.sources("base")
    edited = mm_ablations.sources(name)
    assert set(edited) == set(base) and "probe_mm.cu" in base
    changed = {f for f in base if edited[f] != base[f]}
    assert changed == {f for f, _, _ in mm_ablations.ABLATIONS[name]}


def test_mm_ablations_need_a_card_and_known_names():
    with pytest.raises(SystemExit, match="unknown ablations"):
        mm_ablations.main(["no_such"])
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        mm_ablations.main(["no_b"])
