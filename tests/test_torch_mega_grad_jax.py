"""The port's megakernel gradient path against the JAX package's on the CPU
(JAX's tape-mode kernel in interpret mode, its XLA replay):

- fed JAX's own tape and seed, the port's replay gives JAX's replay image
  and JAX's gradients w.r.t. the texture colours;
- the tape seed is JAX's draw from the same key;
- exact-spp mode at JAX's tape default T = 1024 records JAX's tape.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as jmg  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 5e-5


def _words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("name", ["random_balls", "cornell_box",
                                  "cornell_smoke"])
def test_port_replay_of_jax_tape_matches_jax_replay(name):
    """16x16x4, depth 5: the image to the replay gate (rtol 1e-3 / atol
    5e-5; measured max abs 5.3e-5 / 2.9e-7 / 9.5e-7), the gradient of
    mean(img^2) w.r.t. textures.color to rtol 1e-3 / atol 1e-6 (measured
    max abs 1.2e-7 / 4.7e-10 / 1.5e-8)."""
    js, ts = jscenes.make_scene(name, 1.0), make_scene(name, 1.0)
    jctx = jmg.plan_tape(js, 16, 16, 4, max_depth=5, T=256)
    _, jtape, jseed = jmg.tape_forward(jax.random.key(3), jctx,
                                       interpret=True)
    jreplay = jmg.make_replay(jctx)

    def jl(c):
        return jnp.mean(jreplay(js.replace(textures=js.textures.replace(
            color=c)), jtape, jseed) ** 2)

    g_j = np.asarray(jax.grad(jl)(js.textures.color))
    img_j = np.asarray(jreplay(js, jtape, jseed))

    ctx = mg.plan_tape(ts, 16, 16, 4, max_depth=5, T=jctx["T"],
                       device="cpu")
    col = torch.tensor(np.asarray(ts.textures.color, np.float32),
                       requires_grad=True)
    img = mg.make_replay(ctx)(
        dataclasses.replace(ts, textures=dataclasses.replace(
            ts.textures, color=col)),
        torch.from_numpy(np.array(jtape)), torch.from_numpy(np.array(jseed)))
    torch.mean(img ** 2).backward()
    np.testing.assert_allclose(img.detach().numpy(), img_j, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(col.grad.numpy(), g_j, rtol=1e-3, atol=1e-6)
    assert np.abs(g_j).sum() > 0


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_tape_seed_is_jax_draw(seed):
    js = jscenes.make_scene("cornell_box", 1.0)
    jctx = jmg.plan_tape(js, 8, 8, 1, max_depth=2, T=128)
    k = jax.random.fold_in(jax.random.key(seed), 5)
    _, _, jseed = jmg.tape_forward(k, jctx, interpret=True)
    got = mg.tape_seed(_words(k), "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 1)
    assert int(got[0, 0]) == int(np.asarray(jseed)[0, 0])


@pytest.mark.parametrize("name", ["random_balls", "cornell_box"])
def test_exact_mode_at_t1024_records_jax_tape(name):
    """JAX's tape default is T = 1024 lanes a tile (mega_grad.py:61): at
    that width the port's exact mode (plain version) records JAX's winner
    on >= 99% of lanes with JAX's seed, and the radiance of those lanes
    matches to the replay gate."""
    js, ts = jscenes.make_scene(name, 1.0), make_scene(name, 1.0)
    jctx = jmg.plan_tape(js, 32, 32, 2, max_depth=4, T=1024)
    assert jctx["T"] == 1024
    img_j, tape_j, jseed = jmg.tape_forward(jax.random.key(9), jctx,
                                            interpret=True)
    ctx = mg.plan_tape(ts, 32, 32, 2, max_depth=4, T=1024, device="cpu")
    assert ctx["plan"].T == 1024 and ctx["n_tiles"] == 1
    args = mk.table_tensors(ctx["tabs"], ts, ctx["plan"], "cpu")
    out = mk.trace_mega_reference(ctx["pixf"], *args,
                                  int(np.asarray(jseed)[0, 0]), ctx["plan"])
    tape = out[:, mk.OUT_ROWS:].numpy()
    assert tape.shape == np.asarray(tape_j).shape
    same = (tape == np.asarray(tape_j)).all(axis=1).reshape(-1)
    inv = ctx["inv"].numpy()
    same_pix = same[inv].reshape(32, 32)
    assert same_pix.mean() >= 0.99, same_pix.mean()
    img = (out[:, 0:3].transpose(1, 2).reshape(-1, 3)[ctx["inv"]]
           .reshape(32, 32, 3) / 2.0).numpy()
    np.testing.assert_allclose(img[same_pix], np.asarray(img_j)[same_pix],
                               rtol=RTOL, atol=ATOL)
