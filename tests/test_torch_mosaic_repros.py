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
are compared, as the repro's `out[:3, 0]` reads.
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
    if case.startswith("seed"):         # normals around -3: negative mins
        rng = np.random.default_rng(int(case[4:]))
        return (rng.standard_normal((8, 128)) * 40.0 - 3.0).astype(
            np.float32)
    span = {"trips0": 0.0, "trips3": 35.0, "trips100": 5000.0}[case]
    x = np.full((8, 128), -2.5, np.float32)
    x[3, 17] = -2.5 + span
    return x


@pytest.mark.parametrize("case", ["repro", "seed1", "seed2", "seed3",
                                  "trips0", "trips3", "trips100"])
def test_k12_plain_version_equals_jax_kernel(repro, case):
    x = _k12_input(case)
    want = _jax_scalar_reduce(repro["repro_scalar_reduce"], x)[:3]
    got = k12.scalar_reduce_reference(torch.from_numpy(x))[:3].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == x.min() and got[1, 0] == x.max()
    if case.startswith("seed"):
        assert x.min() < 0
    trips = {"repro": 3, "trips0": 0, "trips3": 3, "trips100": 100}
    if case in trips:
        assert got[2, 0] == trips[case]


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
    """K10-K14 and the floor each bind one entry of the library, counting
    into its own module's KERNEL_LAUNCHES."""
    entries = {k10._IOTA: k10, k11._SLICE: k11, k12._REDUCE: k12,
               k13._CULL: k13, k14._DOT: k14, launch_floor._EMPTY:
               launch_floor}
    assert len({e.name for e in entries}) == 6
    for e, mod in entries.items():
        assert isinstance(e, _common.Entry)
        assert e.counts is mod.KERNEL_LAUNCHES
    assert not hasattr(_common, "launch")


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("row shape", "expected"),
    ("width", "divide"), ("k14 cpu", "CUDA"), ("k14 tile", "multiples"),
    ("k14 width", r"\(S, 3\)")])
def test_k11_k14_wrappers_refuse_after_one_combined_check(case, match):
    """Past the one combined condition, the K11 and K14 wrappers raise
    what their first versions raised: the plain version's shape and type
    check first, then the tile rule, then the device."""
    row, col = k11.inputs(0)
    tab, rays = k14.inputs(0)
    call = {"cpu": lambda: k11.reg_slice_kernel(row, col),
            "float64": lambda: k11.ref_load_kernel(row.double(), col),
            "row shape": lambda: k11.reg_slice_kernel(row.T, col),
            "width": lambda: k11.ref_load_kernel(row, col, 100),
            "k14 cpu": lambda: k14.subslice_kernel(tab, rays),
            "k14 tile": lambda: k14.dense_kernel(
                tab[:40, 0:3].contiguous(), rays),
            "k14 width": lambda: k14.dense_kernel(tab, rays)}[case]
    with pytest.raises(ValueError, match=match):
        call()


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
