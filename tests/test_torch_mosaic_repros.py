"""The Mosaic repros' plain versions (kernels K10-K14,
raytracingweekend_tpu_torch/tools/mosaic_repros/) against the repros' own
Pallas kernels, run in JAX's interpret mode on the CPU.

Each repro is loaded from tools/mosaic_repros/ with importlib, and its
kernels are called through pl.pallas_call as the repro calls them, with
interpret=True (K12's SMEM scratch needs pltpu.InterpretParams()); K13
goes through the script's own main(), its `run` replaced by a recorder of
JAX's arrays. Inputs are made with numpy from a seed and handed to both
sides. Everything is bit for bit but K14, whose plain versions round the
inputs to TF32 (2^-11 relative each), so they lie within 3 2^-11 sum |a||b|
of JAX's float32 product. K12's kernel writes rows 0..2 only, so rows 0..2
are compared, as the repro's `out[:3, 0]` reads, with NaN by position and
zeros by sign bit.
"""
import contextlib
import importlib.util
import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from raytracingweekend_tpu_torch.ops.integrator import (  # noqa: E402
    _tile_width)
from raytracingweekend_tpu_torch.tools import mosaic_repros  # noqa: E402
from raytracingweekend_tpu_torch.tools.mosaic_repros import (  # noqa: E402
    __main__ as cli, _common, launch_floor, repro_dot_k3_subslice as k14,
    repro_dynamic_cull as k13, repro_f32_iota as k10,
    repro_scalar_reduce as k12, repro_slice_broadcast_layout as k11,
    tile_32768)

REPRO_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                         "mosaic_repros")
ROW_KEYS = {"kernel", "name", "shape", "us", "plain_us", "bound_us",
            "bound_by", "library_us", "library", "max_abs_err", "agrees",
            "forms_equal", "as_expected", "device"}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_repro_{name}", os.path.join(REPRO_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def repro():
    return {name: _load(name) for name in (
        "repro_f32_iota", "repro_slice_broadcast_layout",
        "repro_scalar_reduce", "repro_dynamic_cull",
        "repro_dot_k3_subslice")}


# ---- K10 -------------------------------------------------------------------

@pytest.mark.parametrize("jax_kernel", ["_kernel_f32_iota",
                                        "_kernel_int_iota_cast"])
@pytest.mark.parametrize("port", ["f32_iota_reference",
                                  "int_iota_cast_reference"])
def test_k10_plain_versions_equal_jax_kernels(repro, jax_kernel, port):
    mod = repro["repro_f32_iota"]
    assert (mod.ROWS, mod.T) == (k10.ROWS, k10.T)
    want = np.asarray(pl.pallas_call(
        getattr(mod, jax_kernel),
        out_shape=jax.ShapeDtypeStruct((mod.ROWS, mod.T), jnp.float32),
        interpret=True)())
    got = getattr(k10, port)(k10.ROWS, k10.T, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


# ---- K11 -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", ["reg_slice", "ref_load"])
def test_k11_plain_versions_equal_jax_kernels(repro, form, seed):
    """Seed 0 is the repro's input; T / W = 2, so the second chunk sits at
    lane offset 256."""
    mod = repro["repro_slice_broadcast_layout"]
    assert (mod.SB, mod.T, mod.W) == (k11.SB, k11.T, k11.W)
    row, col = k11.inputs(seed)
    jax_kernel = {"reg_slice": mod._kernel_reg_slice,
                  "ref_load": mod._kernel_ref_load}[form]
    want = np.asarray(pl.pallas_call(
        jax_kernel,
        out_shape=jax.ShapeDtypeStruct((mod.SB, mod.T), jnp.float32),
        interpret=True)(jnp.asarray(row.numpy()), jnp.asarray(col.numpy())))
    got = getattr(k11, f"{form}_reference")(row, col).numpy()
    np.testing.assert_array_equal(got, want)
    if seed == 0:   # the repro's own draw
        rng = np.random.default_rng(0)
        np.testing.assert_array_equal(
            row.numpy(), rng.standard_normal((1, mod.T)).astype(np.float32))


# ---- K12 -------------------------------------------------------------------

def _jax_scalar_reduce(mod, x: np.ndarray) -> np.ndarray:
    return np.asarray(pl.pallas_call(
        mod.kernel,
        in_specs=[pl.BlockSpec((8, 128), lambda: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=[pltpu.SMEM((4,), jnp.float32)],
        interpret=pltpu.InterpretParams())(jnp.asarray(x)))


def _k12_input(case: str) -> np.ndarray:
    if case == "repro":
        return k12.repro_input().numpy()
    if case in k12.EDGE_CASES:          # F6 / F8: NaN, inf, signed zeros
        return k12.edge_input(case).numpy()
    if case.startswith("seed"):         # normals around -3: negative mins
        rng = np.random.default_rng(int(case[4:]))
        return (rng.standard_normal((8, 128)) * 40.0 - 3.0).astype(
            np.float32)
    span = {"trips0": 0.0, "trips3": 35.0, "trips100": 5000.0}[case]
    x = np.full((8, 128), -2.5, np.float32)
    x[3, 17] = -2.5 + span
    return x


# rows 0..2 (min, max, trips) of the edge inputs (JAX's, in interpret mode)
K12_EDGE = {"nan first": ("nan", "nan", 0), "nan middle": ("nan", "nan", 0),
            "nan last": ("nan", "nan", 0), "inf": ("-inf", "inf", 100),
            "all inf": ("inf", "inf", 0),
            "+0 with -0 first": ("-0", "0", 0),
            "+0 with -0 last": ("-0", "0", 0),
            "-0 with +0 first": ("-0", "0", 0),
            "-0 with +0 last": ("-0", "0", 0), "all +0": ("0", "0", 0),
            "all -0": ("-0", "-0", 0)}


@pytest.mark.parametrize("case", ["repro", "seed1", "seed2", "seed3",
                                  "trips0", "trips3", "trips100",
                                  *k12.EDGE_CASES])
def test_k12_plain_version_equals_jax_kernel(repro, case):
    """Bit for bit with the repro's kernel in interpret mode, signed zeros
    by their sign bits (assert_array_equal counts -0.0 equal to +0.0), NaN
    by position only (torch's NaN has its sign bit set, JAX's not): F6's
    NaN and infinities, F8's zeros (XLA's min of +0.0 and -0.0 is -0.0,
    its max +0.0, in either order)."""
    x = _k12_input(case)
    want = _jax_scalar_reduce(repro["repro_scalar_reduce"], x)[:3]
    got = k12.scalar_reduce_reference(torch.from_numpy(x))[:3].numpy()
    np.testing.assert_array_equal(got, want)
    num = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))
    assert k12.rows_equal(torch.from_numpy(got), torch.tensor(want))
    if case in K12_EDGE:
        expect = np.array(K12_EDGE[case], np.float32)[:, None]
        assert k12.rows_equal(torch.from_numpy(got), torch.from_numpy(
            np.repeat(expect, got.shape[1], axis=1)))
        return
    assert got[0, 0] == x.min() and got[1, 0] == x.max()
    if case.startswith("seed"):
        assert x.min() < 0
    trips = {"repro": 3, "trips0": 0, "trips3": 3, "trips100": 100}
    if case in trips:
        assert got[2, 0] == trips[case]


def test_k12_rows_equal_counts_nan_by_position_and_zeros_by_sign():
    """`rows_equal` compares rows 0..2 only: NaN of any sign or payload at
    the same places, -0.0 unequal to +0.0."""
    a = torch.zeros((8, 4))
    b = a.clone()
    b[5] = 7.0                                  # row 5: not compared
    assert k12.rows_equal(a, b)
    a[1, 2], b[1, 2] = float("nan"), -float("nan")
    assert k12.rows_equal(a, b)
    b[0, 0] = -0.0
    assert not k12.rows_equal(a, b)
    b[0, 0] = float("nan")
    assert not k12.rows_equal(a, b)


# ---- K13 -------------------------------------------------------------------

def _jax_probes(mod, monkeypatch, scalars=None) -> dict:
    """The repro's main() with `run` recording each probe's array."""
    got = {}

    def record(name, fn, expect):
        got[name] = (np.asarray(jax.jit(fn)()), np.asarray(expect))
        return True

    monkeypatch.setattr(mod, "run", record)
    if scalars is not None:
        monkeypatch.setattr(mod, "_SCALARS", np.asarray(scalars, np.int32))
    mod.main()
    return got


@pytest.mark.parametrize("scalars", [None, (5, 1, 2, 0)])
def test_k13_plain_versions_equal_jax_probes(repro, monkeypatch, scalars):
    """The repro's scalars (3, 2, 3, 0), and a second set whose slices are
    in range and whose ids C reads were all written (s[2] <= 3)."""
    mod = repro["repro_dynamic_cull"]
    s = tuple(int(v) for v in (mod._SCALARS if scalars is None
                               else scalars))
    if scalars is None:
        assert s == k13.SCALARS
    got_jax = _jax_probes(mod, monkeypatch, scalars)
    assert list(got_jax) == list(k13.FORMS)
    a = k13.inputs(s)
    want_np = k13.expected(s)
    for k, name in enumerate(k13.FORMS):
        jax_out, _ = got_jax[name]
        port = k13.reference(k, a).numpy()
        np.testing.assert_array_equal(port, jax_out)
        np.testing.assert_array_equal(port, want_np[name])
        assert port.dtype == jax_out.dtype
    if scalars is None:     # the repro's own expected arrays
        for name, (jax_out, expect) in got_jax.items():
            np.testing.assert_array_equal(want_np[name], expect)


# F4's scalars: every start wraps in int32 (k * 8 = 2^32 + 16, k * 128 =
# 2^36 + 128; C's ids 2^29, 2^29 + 2, 2^29 + 4 times 8 = 0, 16, 32 mod 2^32)
# and lands inside the table, so the interpreter's answer is defined
WRAPPED = (2 ** 29 + 2, 2 ** 29 + 1, 3, 0)


def test_k13_plain_versions_wrap_their_starts_as_jax_does(repro,
                                                          monkeypatch):
    """The slice starts are JAX's int32 products, wrapped, then clamped:
    A is tab[16:24], B att[:, 128:256], C tab[0:8] + tab[16:24] +
    tab[32:40], bit for bit with the repro's probes in interpret mode (a
    start computed in 64 bits clamps to tab[56:64] and att[:, 384:512])."""
    mod = repro["repro_dynamic_cull"]
    got_jax = _jax_probes(mod, monkeypatch, WRAPPED)
    a = k13.inputs(WRAPPED)
    tab, att = a["tab"].numpy(), a["att"].numpy()
    want = {k13.FORMS[0]: tab[16:24], k13.FORMS[1]: att[:, 128:256],
            k13.FORMS[2]: (tab[0:8] + tab[16:24]) + tab[32:40]}
    for k, name in enumerate(k13.FORMS):
        port = k13.reference(k, a).numpy()
        np.testing.assert_array_equal(port, got_jax[name][0])
        assert port.dtype == got_jax[name][0].dtype
        if name in want:
            np.testing.assert_array_equal(port, want[name])
    assert [k13.reference(k, a).numpy().flat[0] for k in range(3)] == [
        2048.0, 128.0, 6144.0]


@pytest.mark.parametrize("k,size,extent,start", [
    (2 ** 29 + 2, 8, 64, 16), (2 ** 28, 8, 64, 0), (2 ** 28 - 1, 8, 64, 56),
    (-1, 8, 64, 0), (3, 128, 512, 384), (2 ** 25, 128, 512, 0),
    (2 ** 29 + 1, 128, 512, 128)])
def test_k13_start_is_the_wrapped_int32_product_clamped(k, size, extent,
                                                        start):
    """2^28 * 8 wraps to -2^31 (clamped to 0, where the interpreter
    raises); (2^28 - 1) * 8 stays positive and clamps to the last block."""
    got = k13._start(torch.tensor(k, dtype=torch.int32), size, extent)
    assert got.dtype == torch.int64 and got.item() == start


def test_k13_fori_sums_normal_tables_in_id_order():
    """On random normal tables (numpy seed) C's plain version is the
    float32 sum ((0 + b0) + b1) + b2 of the blocks the ids name, bit for
    bit; another order gives other bits, so the order is pinned."""
    rng = np.random.default_rng(11)
    tab = rng.standard_normal((k13.S, k13.LANES)).astype(np.float32)
    s = (5, 1, 3, 0)                    # ids 3, 5, 4
    got = k13.fori_smem_reference(torch.tensor(s, dtype=torch.int32),
                                  torch.from_numpy(tab)).numpy()
    acc = np.zeros((8, k13.LANES), np.float32)
    for i in (3, 5, 4):
        acc = acc + tab[8 * i:8 * i + 8]
    np.testing.assert_array_equal(got, acc)
    backwards = (tab[32:40] + tab[40:48]) + tab[24:32]
    assert not np.array_equal(got, backwards)


@pytest.mark.parametrize("scalars", [(3, 2, 0, 0), (3, 2, -1, 0),
                                     (3, 2, -(2 ** 31), 0)])
def test_k13_fori_takes_no_block_at_n_zero_or_below(repro, monkeypatch,
                                                    scalars):
    """n = 0 and negative n: no block is summed, as the repro's fori_loop
    with that trip count runs no iteration (zeros, bit for bit)."""
    mod = repro["repro_dynamic_cull"]
    got_jax = _jax_probes(mod, monkeypatch, scalars)
    a = k13.inputs(scalars)
    port = k13.reference(2, a).numpy()
    np.testing.assert_array_equal(port, got_jax[k13.FORMS[2]][0])
    np.testing.assert_array_equal(port, np.zeros((8, k13.LANES),
                                                 np.float32))


def test_k13_fori_at_n_eight_reads_the_unwritten_ids_as_zero():
    """n = 8: the three written ids, then five ids the kernel did not
    write, 0 (block 0), summed in order; on normal tables (numpy seed)."""
    rng = np.random.default_rng(12)
    tab = rng.standard_normal((k13.S, 20)).astype(np.float32)
    got = k13.fori_smem_reference(torch.tensor((4, -3, 8, 0),
                                               dtype=torch.int32),
                                  torch.from_numpy(tab)).numpy()
    acc = np.zeros((8, 20), np.float32)
    for i in (2, 4, 5, 0, 0, 0, 0, 0):
        acc = acc + tab[8 * i:8 * i + 8]
    np.testing.assert_array_equal(got, acc)


def test_k13_compaction_on_other_votes():
    """D keeps ascending order and the -1 fill for any vote pattern (a
    threshold of > 0: zero and negative votes do not count)."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        v = rng.choice([-1.0, 0.0, 1.0], size=(8, 4)).astype(np.float32)
        got = k13.compaction_reference(torch.from_numpy(v)).numpy()
        ids = [c for c in range(8) if v[c, 0] > 0]
        np.testing.assert_array_equal(got, ids + [-1] * (8 - len(ids)))


# ---- K14 -------------------------------------------------------------------

def _jax_dot(mod, form, tab, rays):
    lhs = tab if form == "subslice" else tab[:, 0:3].copy()
    kern = mod._kernel_subslice if form == "subslice" else mod._kernel_dense
    return np.asarray(pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((mod.S, mod.T), jnp.float32),
        interpret=True)(jnp.asarray(lhs), jnp.asarray(rays)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["subslice", "dense"])
def test_k14_plain_versions_match_jax_kernels(repro, form, seed):
    """Within TF32's input rounding, 3 2^-11 sum |a||b|; the table's lanes
    3..7 are nonzero, so a plain version that read them would fail."""
    mod = repro["repro_dot_k3_subslice"]
    assert (mod.S, mod.T, mod.LANES) == (k14.S, k14.T, k14.LANES)
    tab, rays = k14.inputs(seed)
    assert (tab[:, 3:8] != 0).all()
    want = _jax_dot(mod, form, tab.numpy(), rays.numpy())
    lhs = tab if form == "subslice" else tab[:, 0:3].contiguous()
    got = getattr(k14, f"{form}_reference")(lhs, rays).numpy()
    a, b = np.abs(tab[:, 0:3].numpy()), np.abs(rays.numpy())
    tol = 3 * 2.0 ** -11 * (a.astype(np.float64) @ b)
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    assert not np.array_equal(got, want)       # the TF32 rounding shows


def test_k14_plain_forms_equal_each_other():
    tab, rays = k14.inputs(3)
    np.testing.assert_array_equal(
        k14.subslice_reference(tab, rays).numpy(),
        k14.dense_reference(tab[:, 0:3].contiguous(), rays).numpy())


def test_k14_tolerance_is_two_ulp_of_the_magnitude():
    tab = torch.tensor([[1.0, 0.5, 0.25] + [0.0] * 125,
                        [0.0] * 128], dtype=torch.float32)
    rays = torch.tensor([[1.0], [1.0], [1.0]], dtype=torch.float32)
    tol = k14.tolerance(tab, rays)
    assert tol[0, 0].item() == 2 * 2.0 ** -23      # 1.75: ulp 2^-23
    assert tol[1, 0].item() == 0.0


# ---- the tile width and the tools' surface ---------------------------------

def test_port_tile_width_keeps_the_faulting_shape():
    """The port has no 1 << 15 guard: 2^19 slots at k = 16 give the TPU's
    faulting tile, which tile_32768.run() renders on the card."""
    assert _tile_width(1 << 19, 16) == 1 << 15
    assert _tile_width(1 << 20, 16) == 1 << 16
    assert _tile_width(tile_32768.SLOTS, tile_32768.SPP //
                       tile_32768.SPP_PER_SLOT) == 1 << 15


def test_cli_on_cpu_prints_rows_with_every_key(capsys):
    assert cli.main(["--device", "cpu", "--launches", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert [r["kernel"] for r in rows] == (
        ["K10"] * 2 + ["K11"] * 2 + ["K12"] + ["K13"] * 4 + ["K14"] * 2)
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["device"] == "cpu (plain version)"
        assert r["agrees"] and r["as_expected"]
        assert r["forms_equal"] in (True, None)
        assert (r["library_us"] is None) == (r["kernel"] not in ("K11",
                                                                 "K14"))
        assert r["bound_us"] > 0 and r["bound_by"] == "bytes"
    verdicts = [line for line in lines if not line.startswith("{")]
    assert "f32 iota: builds and is exact in the plain version (CPU)" in \
        verdicts
    assert "D scalar-compaction-smem: OK" in verdicts
    assert len(verdicts) == 11


def test_cli_only_and_launch_counts(capsys):
    mosaic_repros.reset_launches()
    assert cli.main(["--device", "cpu", "--launches", "1", "--only",
                     "k12,k13"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["kernel"] for r in rows] == ["K12"] + ["K13"] * 4
    # the plain versions launch no kernel
    assert set(mosaic_repros.kernel_launches().values()) == {0}
    assert len(mosaic_repros.kernel_launches()) == 11
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--only", "k15"])


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """CPU tensors and shapes off a kernel's tiling raise ValueError; the
    default device raises without a card."""
    row, col = k11.inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        k11.reg_slice_kernel(row, col)
    with pytest.raises(ValueError, match="divide"):
        k11.ref_load_reference(row, col, 100)
    tab, rays = k14.inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        k14.subslice_kernel(tab, rays)
    with pytest.raises(ValueError, match=r"\(S, 3\)"):
        k14.dense_reference(tab, rays)
    with pytest.raises(ValueError, match="CUDA"):
        k10.f32_iota_kernel(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        k12.scalar_reduce_kernel(k12.repro_input())
    a = k13.inputs()
    with pytest.raises(ValueError, match="CUDA"):
        k13.fori_smem_kernel(a["s"], a["tab"])
    with pytest.raises(ValueError, match="votes"):
        k13.compaction_reference(torch.zeros((40, 2)))
    with pytest.raises(ValueError, match="int32"):
        k13.sublane_slice_reference(a["s"].long(), a["tab"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mosaic_repros.run("cuda", ["k10"], 1)


# ---- the launcher (_common.Entry) against a stub library -------------------

class _StubFn:
    """A ctypes function of the stub library: records its argument blocks,
    returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.blocks = rc, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.blocks.append(args)
        return self.rc


class _StubLib:
    """Stands in for the kernel library's CDLL: counts each look-up of an
    entry by name; `rtw_error_string` names the error as CUDA would."""

    def __init__(self):
        self.looked_up = {}
        self.entry = _StubFn()

    def __getattr__(self, name):
        self.looked_up[name] = self.looked_up.get(name, 0) + 1
        if name == "rtw_error_string":
            return _ErrorString()
        return self.entry


class _ErrorString:
    argtypes = restype = None

    def __call__(self, rc):
        return {9: b"invalid configuration argument"}.get(rc, b"?")


@pytest.fixture
def stub(monkeypatch):
    """A launcher over a stub library, on one stub card (device 0), each
    device's current stream handle 0x5000 + its index. Returns (entry,
    library, counts, loads)."""
    monkeypatch.setattr(_common, "cuda_state", lambda: (
        1, lambda: 0, lambda dev: 0x5000 + dev))
    lib, counts, loads = _StubLib(), {"K99 a": 0, "K99 b": 0}, []

    def load():
        loads.append(1)
        return lib
    entry = _common.Entry("K99", "rtw_stub_launch", 3, counts, lib=load)
    return entry, lib, counts, loads


def test_launcher_binds_each_entry_once(stub):
    """The library is loaded, the entry looked up and its argtypes set at
    the first launch only."""
    entry, lib, _, loads = stub
    assert loads == [] and lib.looked_up == {}     # nothing before a launch
    for _ in range(3):
        entry.launch("K99 a", 0, 1, 2, 3)
    assert loads == [1]
    assert lib.looked_up["rtw_stub_launch"] == 1
    assert lib.entry.restype is not None
    assert len(lib.entry.argtypes) == 1             # the argument block
    assert len(lib.entry.blocks) == 3


def test_launcher_passes_the_stream_handle_last(stub):
    """The argument block: every argument as an int64 slot, in order
    (addresses past 32 bits uncut), then the current stream's raw handle
    of the tensor's device."""
    entry, lib, _, _ = stub
    addr = (1 << 40) + 12345
    entry.launch("K99 a", 0, 7, addr, -2)
    (block,), = lib.entry.blocks
    assert struct.unpack("<4q", block) == (7, addr, -2, 0x5000)
    with pytest.raises(struct.error):               # three slots, not two
        entry.launch("K99 a", 0, 7, addr)


def test_launcher_raises_with_the_kernel_and_the_error_string(stub):
    """A non-zero return (the card refused the launch) raises
    RuntimeError naming the kernel and the library's error string, and
    counts nothing."""
    entry, lib, counts, _ = stub
    lib.entry.rc = 9
    with pytest.raises(RuntimeError, match=r"K99 launch failed: CUDA error "
                       r"9 \(invalid configuration argument\)"):
        entry.launch("K99 a", 0, 1, 2, 3)
    assert counts == {"K99 a": 0, "K99 b": 0}


def test_launcher_counts_each_launch(stub):
    entry, _, counts, _ = stub
    for key in ("K99 a", "K99 b", "K99 a"):
        entry.launch(key, 0, 1, 2, 3)
    assert counts == {"K99 a": 2, "K99 b": 1}


def test_launcher_switches_the_device_only_when_not_current(monkeypatch):
    """On a machine of two cards, a launch on the current card reads the
    current device and switches nothing; one on the other card launches
    inside torch.cuda.device(that card), on that card's stream."""
    reads, switched = [], []

    def current():
        reads.append(1)
        return 0

    @contextlib.contextmanager
    def device(dev):
        switched.append(dev)
        yield

    monkeypatch.setattr(_common, "cuda_state", lambda: (
        2, current, lambda dev: 0x5000 + dev))
    monkeypatch.setattr(torch.cuda, "device", device)
    lib, counts = _StubLib(), {"K99 a": 0}
    entry = _common.Entry("K99", "rtw_stub_launch", 1, counts,
                          lib=lambda: lib)
    entry.launch("K99 a", 0, 5)
    assert switched == [] and len(reads) == 1
    entry.launch("K99 a", 1, 6)
    assert switched == [1] and len(reads) == 2
    assert [struct.unpack("<2q", b)[1] for (b,) in lib.entry.blocks] == [
        0x5000, 0x5001]
    assert counts == {"K99 a": 2}


def test_every_wrapper_launches_through_one_entry_each():
    """K10-K14 and the floor each bind one entry of the library (K12 two:
    its one block and its grid), counting into its own module's
    KERNEL_LAUNCHES."""
    entries = {k10._IOTA: k10, k11._SLICE: k11, k12._REDUCE: k12,
               k12._REDUCE_GRID: k12, k13._CULL: k13, k14._DOT: k14,
               launch_floor._EMPTY: launch_floor}
    assert len({e.name for e in entries}) == 7
    for e, mod in entries.items():
        assert isinstance(e, _common.Entry)
        assert e.counts is mod.KERNEL_LAUNCHES
    assert not hasattr(_common, "launch")


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("row shape", "expected"),
    ("width", "divide"), ("k14 cpu", "CUDA"), ("k14 tile", "multiples"),
    ("k14 width", r"\(S, 3\)"), ("k10 cpu", "CUDA"),
    ("k10 no rows", r"rows in \[1, 2\^24\]"),
    ("k10 rows past 2^24", r"2\^24"), ("k10 no cols", "cols >= 1"),
    ("k13 cpu", "CUDA"), ("k13 int64", "int32"),
    ("k13 two scalars", r"\(>= 3,\)"), ("k13 narrow", ">= 128 columns"),
    ("k13 short", ">= 8 rows"), ("k13 float64", "float32"),
    ("k13 votes", "votes"), ("k13 votes cpu", "CUDA"), ("k12 cpu", "CUDA"),
    ("k12 float64", "float32"), ("k12 two rows", r"rows >= 3"),
    ("k12 one dim", r"\(rows >= 3, cols\)"),
    ("k12 not contiguous", "CUDA")])
def test_k11_k14_wrappers_refuse_after_one_combined_check(case, match):
    """Past the one combined condition, the K10-K14 wrappers raise what
    their first versions raised: the plain version's shape and type check
    first, then the tile rule, then the device (K10: a device that is not
    CUDA)."""
    row, col = k11.inputs(0)
    tab, rays = k14.inputs(0)
    a = k13.inputs()
    x12 = k12.repro_input()
    call = {"cpu": lambda: k11.reg_slice_kernel(row, col),
            "float64": lambda: k11.ref_load_kernel(row.double(), col),
            "row shape": lambda: k11.reg_slice_kernel(row.T, col),
            "width": lambda: k11.ref_load_kernel(row, col, 100),
            "k14 cpu": lambda: k14.subslice_kernel(tab, rays),
            "k14 tile": lambda: k14.dense_kernel(
                tab[:40, 0:3].contiguous(), rays),
            "k14 width": lambda: k14.dense_kernel(tab, rays),
            "k10 cpu": lambda: k10.f32_iota_kernel(device="cpu"),
            "k10 no rows": lambda: k10.int_iota_cast_kernel(0, 4, "cpu"),
            "k10 rows past 2^24": lambda: k10.f32_iota_kernel(
                2 ** 24 + 1, 1, "cuda"),
            "k10 no cols": lambda: k10.int_iota_cast_kernel(4, 0, "cuda"),
            "k13 cpu": lambda: k13.fori_smem_kernel(a["s"], a["tab"]),
            "k13 int64": lambda: k13.sublane_slice_kernel(a["s"].long(),
                                                          a["tab"]),
            "k13 two scalars": lambda: k13.fori_smem_kernel(a["s"][:2],
                                                            a["tab"]),
            "k13 narrow": lambda: k13.lane_slice_kernel(a["s"],
                                                        a["att"][:, :100]),
            "k13 short": lambda: k13.sublane_slice_kernel(a["s"],
                                                          a["tab"][:7]),
            "k13 float64": lambda: k13.fori_smem_kernel(a["s"],
                                                        a["tab"].double()),
            "k13 votes": lambda: k13.compaction_kernel(torch.zeros((40, 2))),
            "k13 votes cpu": lambda: k13.compaction_kernel(a["votes"]),
            "k12 cpu": lambda: k12.scalar_reduce_kernel(x12),
            "k12 float64": lambda: k12.scalar_reduce_kernel(x12.double()),
            "k12 two rows": lambda: k12.scalar_reduce_kernel(x12[:2]),
            "k12 one dim": lambda: k12.scalar_reduce_kernel(x12.flatten()),
            "k12 not contiguous": lambda: k12.scalar_reduce_kernel(
                x12.T)}[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_k10_wrapper_allocates_from_its_resolved_device(monkeypatch):
    """The K10 wrapper resolves its device argument once (a CUDA device is
    kept; a CPU one raises every call and is never kept), allocates its
    output from the resolved device's empty tensor and launches on its
    index, with the form, the output's address and the shape."""
    launched = []

    class Stub:
        def launch(self, key, dev, *args):
            launched.append((key, dev, args))

    monkeypatch.setattr(k10, "_IOTA", Stub())
    monkeypatch.setattr(k10, "_TARGETS", {"cuda:7": (torch.empty(0), 7)})
    out = k10.int_iota_cast_kernel(3, 5, "cuda:7")
    assert out.shape == (3, 5) and out.dtype == torch.float32
    ((key, dev, args),) = launched
    assert (key, dev) == ("K10 int iota + cast", 7)
    assert args == (1, out.data_ptr(), 3, 5)
    for _ in range(2):
        with pytest.raises(ValueError, match="CUDA"):
            k10.f32_iota_kernel(device="cpu")
    assert list(k10._TARGETS) == ["cuda:7"]


def test_launch_floor_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        launch_floor.run("cpu")


@pytest.mark.parametrize("flag", [False, True])
def test_k14_yardstick_leaves_tf32_as_it_found_it(flag):
    """The K14 rows time TF32 torch.matmul with allow_tf32 set on inside
    `tf32()` and restore the flag after."""
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        with k14.tf32():
            assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 == flag
        rows = k14.run("cpu", launches=1)
        assert torch.backends.cuda.matmul.allow_tf32 == flag
        assert all("set once" in r["library"] for r in rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_k14_yardstick_is_timed_inside_one_tf32_context(monkeypatch):
    """Each K14 row enters `tf32()` once, around every call of its
    yardstick (warm-ups and timed calls), not once a call."""
    state = {"inside": False, "enters": 0, "calls": 0, "outside": 0}

    @contextlib.contextmanager
    def counting():
        state["enters"] += 1
        state["inside"] = True
        try:
            yield
        finally:
            state["inside"] = False

    real = k14.library

    def library(tab, rays):
        fn = real(tab, rays)

        def call():
            state["calls"] += 1
            state["outside"] += not state["inside"]
            return fn()
        return call

    monkeypatch.setattr(k14, "tf32", counting)
    monkeypatch.setattr(k14, "library", library)
    rows = k14.run("cpu", launches=3)
    assert len(rows) == 2 and state["enters"] == 2
    assert state["calls"] == 2 * (2 + 3) and state["outside"] == 0
