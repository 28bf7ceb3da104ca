"""The windowed two-step comparison of tests/test_torch_window.py from the
state that JAX's "rbg" PRNG gives `jax.random.PRNGKey(0)` (the JAX
package's Trainer leaves that default behind in a process; the tests pin
threefry2x32 with `threefry_keys`). Prints each VAE parameter tensor with an
entry past the test's bar (atol 1e-5, rtol 1e-4), its worst entry, and that
entry's first moment after each step in both packages, against its
tensor's largest. Not a test (pytest does not collect it); run on the CPU:

    JAX_PLATFORMS=cpu python tests/probe_window_step_rbg.py [rbg|threefry2x32]
"""

import dataclasses
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_prng_impl",
                  sys.argv[1] if len(sys.argv) > 1 else "rbg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_train import (  # noqa: E402
    _fixed_eps, _rounding_noise_only, _tiny, jstate, jstep, step,
    train_state_from_jax, vae_state_dict_from_jax)


def main() -> None:
    mp = pytest.MonkeyPatch()
    cfg, vcfg, tcfg = _tiny(48)
    cfg = cfg.replace(attn_window=256)
    tcfg = dataclasses.replace(tcfg, attn_window=256)
    _fixed_eps(mp, np.random.default_rng(6).standard_normal((2, 16))
               .astype(np.float32))
    js = jstate.create_state(jax.random.PRNGKey(0), cfg, vcfg, tcfg)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), cfg,
                              vcfg, tcfg)
    jfn = jax.jit(jstep.make_train_step(cfg, vcfg, tcfg))
    tfn = step.make_train_step(cfg)
    r = np.random.default_rng(7)
    mus, exp_avgs = [], []
    for _ in range(2):
        images = r.integers(0, 256, (2, 2, 48, 48, 3), dtype=np.uint8)
        js, _ = jfn(js, jnp.asarray(images))
        ts, _ = tfn(ts, torch.from_numpy(images), None)
        mus.append(vae_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, js.vae_opt[1][0].mu), vcfg))
        exp_avgs.append({k: ts.vae_opt.opt.state[p]["exp_avg"].numpy().copy()
                         for k, p in ts.vae.named_parameters()})
    want = vae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, js.vae_params), vcfg)
    got = ts.vae.state_dict()
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "last_spatial_shapes")):
            continue
        a, b = got[k].numpy(), w.numpy()
        tol = 1e-5 + 1e-4 * np.abs(b)
        bad = (np.abs(a - b) > tol) & ~_rounding_noise_only(k, w.shape, vcfg)
        if not bad.any():
            continue
        at = np.unravel_index(np.argmax(np.abs(a - b) - tol), a.shape)
        print(f"vae.{k} {tuple(a.shape)}: {int(bad.sum())} of {a.size} past "
              f"the bar; worst {tuple(int(i) for i in at)} off by "
              f"{abs(a - b)[at]:.3e} (bar {tol[at]:.3e})")
        for i in range(2):
            m = mus[i][k].numpy()
            print(f"  after step {i + 1}: optax mu {m[at]:.3e}, the port's "
                  f"exp_avg {exp_avgs[i][k][at]:.3e}, |mu| over the tensor's "
                  f"largest {abs(m[at]) / np.abs(m).max():.2e}, share of the "
                  f"tensor's entries with a smaller |mu| "
                  f"{(np.abs(m) < abs(m[at])).mean():.4f}")


if __name__ == "__main__":
    main()
