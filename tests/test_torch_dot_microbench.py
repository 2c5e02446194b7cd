"""The dot-formulation microbenchmark's plain versions (kernel K9) against
the tool's bodies.

tools/dot_microbench.py keeps its kernel bodies as closures inside
`main()`, discards their results and has no interpret mode. So the JAX
side here is each body's `f`, copied into jax.numpy from
tools/dot_microbench.py:107-205 (line references at each copy), run under
jit at Precision.HIGHEST for N steps at a small S and T, and the port's
plain versions (raytracingweekend_tpu_torch/tools/dot_microbench.py) are
held to it:

- FP32 ("f32 HIGHEST", elemq, minmask): the same arithmetic up to the
  order of a dot's sum, so each element within n_terms * 2^-24 of the
  sum of the absolute terms (|A| @ |B|), doubled for extract, whose
  steps halve and re-add (a * 0.5 + r); elemq and minmask have no dot
  and must be equal;
- TF32 ("f32 default") and bf16: the port rounds the matrix to TF32
  (2^-11 relative) or bf16 (2^-8), so that much of |A| @ |B| more.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu_torch.tools import (  # noqa: E402
    dot_microbench as dm)

torch.set_num_threads(2)

S, T, N = 128, 32, 3
HI = jax.lax.Precision.HIGHEST
U32 = 2.0 ** -24
U_IN = {"fp32": 0.0, "tf32": 2.0 ** -11, "bf16": 2.0 ** -8}
ROW_KEYS = {"name", "h100_unit", "S", "T", "iters", "us_per_iter",
            "ops_per_iter", "ops_per_s", "bound_us_per_iter",
            "library_us_per_iter", "device"}


def _dot(lhs, rhs, dims):
    return jax.lax.dot_general(lhs, rhs, (dims, ((), ())), precision=HI,
                               preferred_element_type=jnp.float32)


def _jax_body(body):
    """The tool's `f(a, i)` of each body, with its table as an argument."""
    if body == "lane16":                 # dot_microbench.py:108-113
        def f(a, mx):
            rhs = a[0:16, :] * 1e-30 + 1.0
            return _dot(mx, rhs, ((1,), (0,)))
    elif body == "sub16":                # :124-129
        def f(a, mxt):
            rhs = a[0:16, :] * 1e-30 + 1.0
            return _dot(mxt, rhs, ((0,), (0,)))
    elif body == "extract":              # :144-150 (and :157-162)
        def f(a, at):
            m = (a == 0.0).astype(jnp.float32)
            r = _dot(at, m, ((1,), (0,)))
            return a * 0.5 + jnp.pad(r, ((0, a.shape[0] - 24), (0, 0)))
    elif body == "elemq":                # :173-197
        def f(a, sph):
            ox = a[0:1, :] * 1e-30 + 1.0
            oy, oz = ox, ox
            dx = ox * 0.5
            dy, dz = dx, dx
            tmv = ox * 0.1
            cx = sph[:, 0:1]
            cy = sph[:, 1:2]
            cz = sph[:, 2:3]
            frac = (tmv - sph[:, 6:7]) * sph[:, 7:8]
            cx = cx + frac * sph[:, 3:4]
            cy = cy + frac * sph[:, 4:5]
            cz = cz + frac * sph[:, 5:6]
            ocx = ox - cx
            ocy = oy - cy
            ocz = oz - cz
            b = ocx * dx + ocy * dy + ocz * dz
            cc = (ocx * ocx + ocy * ocy + ocz * ocz - sph[:, 8:9])
            disc = b * b - cc
            sq = jnp.sqrt(disc)
            tn = -b - sq
            tc = jnp.where(tn > 1e-3, tn, -b + sq)
            return jnp.where(tc > 1e-3, tc, 3e37)
    else:                                # :202-204
        def f(a, sph):
            m = jnp.min(a, axis=0, keepdims=True)
            return a + (a == m).astype(jnp.float32)
    return jax.jit(f)


def _jax_run(body, tab):
    """N steps of the tool's body from its initial accumulator
    (body_loop, :96-102): the whole (S, T) accumulator after each step."""
    f = _jax_body(body)
    a = jnp.full((S, T), 1.0 if body == "minmask" else 0.0, jnp.float32)
    steps = []
    for _ in range(N):
        a = f(a, tab)
        steps.append(np.asarray(a))
    return steps


def _port_run(body, unit, tab):
    """N steps of the port's plain step: the whole accumulator after each
    step."""
    a = torch.full((S, T), 1.0 if body == "minmask" else 0.0)
    steps = []
    for _ in range(N):
        a = dm._step(body, unit, a, tab)
        steps.append(a)
    return steps


@pytest.fixture(scope="module")
def tables():
    return dm.make_tables(S)


@pytest.mark.parametrize("name,body,unit", dm.ROWS)
def test_plain_version_matches_tool_body(name, body, unit, tables):
    """Each row's plain version against the tool's body at HIGHEST."""
    tab = dm.table_for(body, unit, tables, "cpu")
    steps = _port_run(body, unit, tab)
    assert torch.equal(dm.microbench_reference(body, unit, tab, S, T, N),
                       steps[-1][0:8])
    wants = _jax_run(body, jnp.asarray(tables[{
        "lane16": "mx", "sub16": "mxt", "extract": "at"}.get(body, "sph")]))
    if body == "elemq":   # the first step has hits and misses
        assert 0.0 < (steps[0] < 1e30).float().mean().item() < 1.0
    mat = {"lane16": tables["mx"], "sub16": tables["mxt"].T,
           "extract": np.pad(tables["at"], ((0, S - 24), (0, 0)))}.get(body)
    for k, (got, want) in enumerate(zip(steps, wants)):
        got = got.numpy()
        assert np.isfinite(got).all()
        if mat is None:
            np.testing.assert_array_equal(got, want)
            continue
        abs_sum = np.abs(mat).sum(axis=1, keepdims=True)   # >= |A| @ |B|
        grow = 2.0 if body == "extract" else 1.0
        tol = grow * ((mat.shape[1] + 2) * U32 + U_IN[unit]) * abs_sum
        assert np.all(np.abs(got - want) <= tol), (k, np.abs(got - want).max())
        if unit != "fp32":   # the input rounding shows
            assert not np.array_equal(got, want)


def test_tables_follow_the_tool():
    """The tool's inputs: normals from default_rng(0), drawn in its order
    (mx, mxt, at, sph), as float32."""
    got = dm.make_tables(64)
    rng = np.random.default_rng(0)
    for name, shape in (("mx", (64, 16)), ("mxt", (16, 64)),
                        ("at", (24, 64)), ("sph", (64, 128))):
        np.testing.assert_array_equal(
            got[name], rng.normal(size=shape).astype(np.float32))
    assert dm.table_for("extract", "bf16", got, "cpu").dtype == \
        torch.bfloat16


def test_round_tf32_is_round_to_nearest_ties_away():
    """TF32 keeps 10 mantissa bits; halfway cases round away from zero
    (cvt.rna), others to nearest."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -12, one + 3 * 2.0 ** -11, 0.0, -2.5],
                     dtype=torch.float32)
    want = [one + 2.0 ** -10, -(one + 2.0 ** -10), one,
            one + 2 * 2.0 ** -10, 0.0, -2.5]
    assert dm.round_tf32(x).tolist() == want


def test_operation_counts():
    """A step's operations by unit at the tool's shape: the product on its
    unit, the elementwise work on fp32."""
    S0, T0 = 512, 2048
    assert dm.ops_per_step("lane16", "tf32", S0, T0) == {
        "tf32": 2 * S0 * 16 * T0, "fp32": 2 * 16 * T0}
    assert dm.ops_per_step("lane16", "fp32", S0, T0) == {
        "fp32": 2 * S0 * 16 * T0 + 2 * 16 * T0}
    assert dm.ops_per_step("extract", "bf16", S0, T0) == {
        "bf16": 2 * 24 * S0 * T0, "fp32": 3 * S0 * T0}
    assert dm.bound_us("elemq", "fp32", S0, T0) == pytest.approx(
        (dm.OPS_ELEMQ * S0 * T0 + 4 * T0) / 67e12 * 1e6)


def test_cli_on_cpu_prints_rows_with_every_key(capsys):
    """`--device cpu` at a tiny size: one JSON row a tool row, in the
    tool's order, the library column where one matmul is the product."""
    assert dm.main(["--device", "cpu", "--S", "64", "--T", "16",
                    "--iters", "1", "--reps", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["name"] for r in rows] == [r[0] for r in dm.ROWS]
    for r, (_, body, unit) in zip(rows, dm.ROWS):
        assert set(r) == ROW_KEYS
        assert r["h100_unit"] == unit
        assert r["iters"] == [1, 4]
        assert r["device"] == "cpu (plain version)"
        assert (r["library_us_per_iter"] is None) == (
            body in ("elemq", "minmask"))


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(tables):
    """CPU tensors, rows the tool has not, and shapes off the kernel's
    tiling raise; the default device raises without a card."""
    tab = dm.table_for("lane16", "fp32", tables, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        dm.microbench_kernel("lane16", "fp32", tab, S, T, 1)
    with pytest.raises(ValueError, match="no bf16 row"):
        dm.microbench_reference("lane16", "bf16", tab, S, T, 1)
    with pytest.raises(ValueError, match="body"):
        dm.microbench_reference("lane32", "fp32", tab, S, T, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.run(64, 16, 1, 1)
