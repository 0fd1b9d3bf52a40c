#!/usr/bin/env python3
"""The JAX package's float32 dense GaussMNMF step on the hard scenario, on the CPU: where it turns non-finite.

The reference half of ``scripts/torch_mnmf_float32_floor.py --mixture
hard``: the same mixture (``hard_speech_mixture()``: 4 formant pseudo-speech
sources in rooms of RT60 0.35 s, 4 channels, 10 s), the same STFT
(512/256: 257 bins x 626 frames), ``n_basis = 8`` and the same start
(``fast_gauss_mnmf_dense``'s draws of ``default_rng(0)``, ``H = I / M``),
through ``ssspy_tpu.ops.splitc.gauss_mnmf_step_sc``, the float32 step that
``ssspy_tpu.fast.fast_gauss_mnmf_dense`` scans, one jitted iteration at a
time. Prints every 10th iteration and the first at which the state is no
longer finite. CPU only (~10 s an iteration on 4 threads):

    python3 scripts/jax_mnmf_float32_hard.py --iterations 100
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ssspy_tpu.fast import to_split  # noqa: E402
from ssspy_tpu.ops.splitc import gauss_mnmf_step_sc, instant_covariance_sc  # noqa: E402
from ssspy_tpu.transform import stft  # noqa: E402
from ssspy_tpu.utils.dataset import hard_speech_mixture  # noqa: E402

N_BASIS = 8


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=100)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as cache:
        images, _ = hard_speech_mixture(cache_dir=cache)
    X = np.asarray(stft(images.sum(axis=0), n_fft=512, hop_length=256))
    M, I, T = X.shape
    rng = np.random.default_rng(0)
    T0 = np.maximum(rng.random((M, I, N_BASIS)), 1e-10).astype(np.float32)
    V0 = np.maximum(rng.random((M, N_BASIS, T)), 1e-10).astype(np.float32)
    H0 = np.zeros((2, M, I, M, M), dtype=np.float32)
    H0[0] = np.eye(M, dtype=np.float32) / M
    XXs = jax.jit(instant_covariance_sc)(jax.device_put(to_split(X)))
    step = jax.jit(lambda state: gauss_mnmf_step_sc(XXs, *state))
    state = (jnp.asarray(T0), jnp.asarray(V0), jnp.asarray(H0))
    print(f"hard mixture: X {X.shape}, float32 split-complex step, n_basis={N_BASIS}", flush=True)
    start = time.perf_counter()
    for it in range(1, args.iterations + 1):
        state = step(state)
        finite = all(bool(jnp.isfinite(a).all()) for a in state)
        if not finite:
            print(f"non-finite at iteration {it} ({time.perf_counter() - start:.1f} s)", flush=True)
            return
        if it % 10 == 0:
            print(f"iteration {it}: finite ({time.perf_counter() - start:.1f} s)", flush=True)
    print(f"finite through {args.iterations} iterations", flush=True)


if __name__ == "__main__":
    main()
