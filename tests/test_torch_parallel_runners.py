"""The (dp, bin) runners of the fixed-point, gradient, FDICA, prox, FastGaussMNMF and time-domain ICA families,
against the JAX package and themselves.

One gloo world per layout, (1, 2), (2, 1), (2, 2) and (1, 4), is spawned
once per module (tests/torch_parallel_worker.py's ``run_runner_world``: the
ranks import no JAX) and runs each runner of ``worker.RUNNERS`` and
``worker.EXTRA`` in complex128 on the CPU at 33 bins, which no layout of 2
or 4 bin shards divides, and at 32, which every one does. Each case per
(runner, bins, layout) is held

- against the JAX package in x64, run in this process, within the JAX
  sharding tests' tolerances (tests/parallel/test_sharding.py:504-787): the
  unsharded batched step (``jax.vmap`` of its ``_sc`` step) for the
  spectral runners, FastGaussMNMF padded against padded as its JAX runner
  documents, and time-domain ICA against the JAX class per utterance;
- against the port's own runner at world size 1, relative 1e-10 (only the
  order of the summations changes);
- on its all-reduces per iteration through the bin hook, at a local batch
  of 1 (2 x 2) and 2 (1 x 2, 1 x 4): the JAX package's pins
  (tests/parallel/test_hlo_collectives.py:241-262), HVA's at the port's 1.

Besides: ``shard_pytree_run``'s ``precompute`` and the split harmonic mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssspy_tpu.parallel as jpar
from ssspy_tpu.bss.ica import GradLaplaceICA, NaturalGradLaplaceICA
from ssspy_tpu.ops.splitc import (
    admm_iva_step_sc,
    grad_laplace_fdica_step_sc,
    grad_laplace_iva_step_sc,
    hva_pds_step_sc,
    pds_iva_step_sc,
)
from ssspy_tpu_torch.ops.prox_steps import (
    cepstral_mask,
    gathered_harmonic_mask,
    harmonic_mask,
    log_magnitude,
)
from ssspy_tpu_torch.parallel import make_layout, shard_pytree_run
from ssspy_tpu_torch.parallel.dryrun import CASES, N_STEPS, PADDED, padded_inputs, reference_case, spawn
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)

WORLDS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
NAMES = worker.RUNNERS + tuple(worker.EXTRA)
# the JAX sharding tests' tolerances for each runner against its unsharded run (tests/parallel/test_sharding.py:
# 504-809); FastGaussMNMF's JAX test runs in float32 at 1e-4, this one in x64 at 1e-10
JAX_TOL = {
    "fast_iva": 1e-7, "faster_iva": 1e-7, "fdica_ip1": 1e-10, "fdica_ip2": 1e-10, "grad_iva": 1e-10,
    "grad_iva_natural": 1e-10, "grad_fdica": 1e-10, "fast_mnmf": 1e-10, "pds_iva": 1e-10, "admm_iva": 1e-10,
    "hva": 1e-9, "ica": 1e-10, "ica_grad": 1e-10,
}
SELF_TOL = 1e-10  # relative, complex128 against world size 1
# the pins of the cases this module adds (HVA at the port's 1, the JAX package's 2: make_batched_hva_runner)
PINS = {"fast_iva": 1, "faster_iva": 1, "fdica_ip1": 0, "fdica_ip2": 0, "grad_iva": 1, "grad_iva_natural": 1,
        "grad_fdica": 0, "fast_mnmf": 2, "pds_iva": 1, "admm_iva": 1, "hva": 1, "ica": 0, "ica_grad": 0}


@pytest.fixture(scope="module")
def world():
    """``world(key)``: the ranks' reports of the world ``WORLDS[key]``, spawned on first use."""
    cache = {}

    def get(key):
        if key not in cache:
            shape = WORLDS[key]
            cache[key] = spawn(shape[0] * shape[1], worker.run_runner_world, (shape,), device="cpu", timeout=300)
        return cache[key]

    return get


def _planar(a):
    """Complex ``(B, ...)`` -> the JAX runners' planar ``(B, 2, ...)``."""
    a = np.asarray(a)
    return jnp.asarray(np.stack([a.real, a.imag], axis=1)) if np.iscomplexobj(a) else jnp.asarray(a)


def _complex(a):
    """Planar ``(B, 2, ...)`` -> complex ``(B, ...)``."""
    a = np.asarray(a)
    return a[:, 0] + 1j * a[:, 1]


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _steps(step):
    def run(X, carry):
        for _ in range(N_STEPS):
            carry = step(X, carry)
        return carry

    return run


def _vmapped(step):
    return jax.vmap(lambda x, c: step(x, *c), in_axes=(0, 0))


def _jax_run(name, inputs):
    """The JAX reference of runner ``name`` on ``inputs``, ``N_STEPS`` steps; the port's layout of outputs."""
    X, carry = inputs
    if name in ("ica", "ica_grad"):
        cls = GradLaplaceICA if name == "ica_grad" else NaturalGradLaplaceICA
        out = []
        for b in range(X.shape[0]):
            ica = cls(record_loss=False)
            ica(jnp.asarray(X[b]), n_iter=N_STEPS)
            out.append(np.asarray(ica.demix_filter))
        return (np.stack(out),)
    batched = {
        "fast_iva": jpar.batched_fast_iva_step_sc, "faster_iva": jpar.batched_faster_iva_step_sc,
        "fdica_ip1": jpar.batched_aux_fdica_ip1_step_sc, "fdica_ip2": jpar.batched_aux_fdica_ip2_step_sc,
        "grad_iva": jax.vmap(grad_laplace_iva_step_sc),
        "grad_iva_natural": jax.vmap(lambda x, w: grad_laplace_iva_step_sc(x, w, natural=True)),
        "grad_fdica": jax.vmap(grad_laplace_fdica_step_sc),
    }
    if name in batched:
        return (_complex(_compiled(_steps(batched[name]), _planar(X), _planar(carry))),)
    if name == "fast_mnmf":
        out = _compiled(_steps(jpar.batched_fast_gauss_mnmf_step_sc), _planar(X), tuple(map(_planar, carry)))
        return (_complex(out[0]),) + tuple(np.asarray(o) for o in out[1:])
    step = {
        "pds_iva": _vmapped(pds_iva_step_sc),
        "hva": _vmapped(hva_pds_step_sc),
        "admm_iva": jax.vmap(lambda x, c: admm_iva_step_sc(x, *c[1:]), in_axes=(0, 0)),
    }[name]
    out = _compiled(_steps(step), _planar(X), tuple(map(_planar, carry)))
    return tuple(_complex(o) for o in out)


def _base(name):
    return worker.EXTRA[name][1] if name in worker.EXTRA else name


@pytest.fixture(scope="module")
def jax_reference():
    """``jax_reference(name, n_bins, shards)``, computed once each (FastGaussMNMF's depends on the padding)."""
    cache = {}

    def get(name, n_bins, shards):
        padded = _base(name) in PADDED
        key = (name, n_bins, shards if padded else 1)
        if key not in cache:
            inputs = worker.runner_inputs(name, n_bins)
            out = _jax_run(name, padded_inputs(_base(name), inputs, shards))
            if padded:  # padded against padded, then the real bins
                out = tuple(o if axis is None else np.take(o, range(n_bins), axis=axis)
                            for o, (axis, _) in zip(out, PADDED[name]))
            cache[key] = out
        return cache[key]

    return get


@pytest.fixture(scope="module")
def world_one():
    """``world_one(name, n_bins, shards)``: the port's runner at world size 1 (padded as ``shards`` pads it)."""
    cache = {}

    def get(name, n_bins, shards):
        key = (name, n_bins, shards if _base(name) in PADDED else 1)
        if key not in cache:
            inputs = worker.runner_inputs(name, n_bins)
            if name in worker.EXTRA:
                layout = make_layout(world_size=1, device="cpu")
                out = (worker.EXTRA[name][0](layout)(inputs[0], inputs[1], N_STEPS),)
            else:
                out = reference_case(name, inputs, shards, "cpu")
            cache[key] = tuple(o.numpy() for o in out)
        return cache[key]

    return get


CASE_IDS = [(name, n_bins, key) for name in NAMES for n_bins in worker.RUNNER_BINS for key in WORLDS]
IDS = [f"{n}-{b}bins-{k}" for n, b, k in CASE_IDS]


@pytest.mark.parametrize("name,n_bins,key", CASE_IDS, ids=IDS)
def test_runner_matches_jax(world, jax_reference, name, n_bins, key):
    got = world(key)[0]["cases"][f"{name}@{n_bins}"]["outputs"]
    ref = jax_reference(name, n_bins, WORLDS[key][1])
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=JAX_TOL[name], rtol=0)


@pytest.mark.parametrize("name,n_bins,key", CASE_IDS, ids=IDS)
def test_runner_matches_world_one_complex128(world, world_one, name, n_bins, key):
    got = world(key)[0]["cases"][f"{name}@{n_bins}"]["outputs"]
    ref = world_one(name, n_bins, WORLDS[key][1])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.abs(g - r).max() <= SELF_TOL * np.abs(r).max()


@pytest.mark.parametrize("name,n_bins,key", CASE_IDS, ids=IDS)
def test_all_reduces_per_iteration_match_the_pins(world, name, n_bins, key):
    """At local batch 1 (2 x 2) and 2 (1 x 2, 1 x 4) alike: one all-reduce carries every utterance's partials."""
    expected = 0 if WORLDS[key][1] == 1 else PINS[name] * N_STEPS
    for rank in world(key):
        assert rank["cases"][f"{name}@{n_bins}"]["calls"] == expected


@pytest.mark.parametrize("key", WORLDS)
def test_every_rank_returns_the_global_result(world, key):
    reports = world(key)
    for rank in reports[1:]:
        for case, got in rank["cases"].items():
            for a, b in zip(got["outputs"], reports[0]["cases"][case]["outputs"]):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("name", worker.RUNNERS)
def test_cases_carry_the_pins(name):
    """The dry run's cases hold the pins this module checks."""
    assert CASES[name].pin == PINS[name]


def test_shard_pytree_run_precompute_runs_once_per_run_on_the_local_block():
    """``precompute(X_local)`` runs once, before the loop, and its result reaches every step as ``pre=``."""
    seen = []

    def precompute(X):
        seen.append(X.shape)
        return X.sum(dim=-1)  # (B, M, I)

    def step(X, carry, bin_sum, pre):
        (W,) = carry
        return (W + pre.mean(dim=1)[..., None, None],)

    X = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 3, 5, 4)))
    W = torch.zeros(2, 5, 3, 3, dtype=X.dtype)
    run = shard_pytree_run(make_layout(device="cpu"), step, x_bin_axis=2, carry_bin_axes=(1,), identity_leaves=(),
                           precompute=precompute)
    (out,) = run(X, (W,), 3)
    assert seen == [(2, 3, 5, 4)]
    assert torch.equal(out, 3 * X.sum(dim=-1).mean(dim=1)[..., None, None].expand(2, 5, 3, 3))


def _spectrogram(seed, shape=(3, 33, 8)):
    rng = np.random.default_rng(seed)
    return torch.complex(torch.from_numpy(rng.standard_normal(shape)), torch.from_numpy(rng.standard_normal(shape)))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_real", [None, 29])
def test_harmonic_mask_is_its_two_stages(dtype, n_real):
    """``cepstral_mask(log_magnitude(Z))`` equals ``harmonic_mask(Z)`` bit for bit, padded or not."""
    Z = _spectrogram(51).to(dtype)
    if n_real is not None:
        Z[:, n_real:] = 0
    got = cepstral_mask(log_magnitude(Z), 1 / 3, mask_iter=2, n_real=n_real)
    assert torch.equal(got, harmonic_mask(Z, 1 / 3, mask_iter=2, n_real=n_real))
    floor = lambda y: torch.clamp(y, min=1e-3)  # noqa: E731
    assert torch.equal(cepstral_mask(log_magnitude(Z, flooring_fn=floor), 0.5),
                       harmonic_mask(Z, 0.5, flooring_fn=floor))


def test_harmonic_mask_takes_a_batch():
    """A batch ``(B, N, I, T)`` gives each utterance's mask."""
    Z = torch.stack([_spectrogram(52), _spectrogram(53)])
    got = harmonic_mask(Z, 1 / 3, mask_iter=2)
    for b in range(2):
        torch.testing.assert_close(got[b], harmonic_mask(Z[b], 1 / 3, mask_iter=2), rtol=1e-14, atol=0)


class _Stop(Exception):
    pass


def _buffer(part, first, n_bins):
    """The buffer a rank holding ``part`` from bin ``first`` hands the hook."""
    seen = []

    def bin_sum(buffer):
        seen.append(buffer.clone())
        raise _Stop

    with pytest.raises(_Stop):
        gathered_harmonic_mask(part, 1 / 3, bin_sum, (first, n_bins))
    return seen[0]


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_gathered_harmonic_mask_equals_the_whole_axis_mask(n_ranks):
    """The ranks' buffers sum to the whole axis's log magnitude exactly, and each rank's slice of the gathered mask
    equals the whole-axis mask on its real bins bit for bit, with one call of the hook; its padded bins are zero."""
    Z = torch.stack([_spectrogram(54), _spectrogram(55)])  # (B, N, 33, T)
    n_bins = Z.shape[-2]
    size = -(-n_bins // n_ranks)
    slices = []
    for r in range(n_ranks):
        part = Z[..., r * size:(r + 1) * size, :]
        slices.append(torch.nn.functional.pad(part, (0, 0, 0, size - part.shape[-2])))
    total = sum(_buffer(part, r * size, n_bins) for r, part in enumerate(slices))
    assert torch.equal(total, log_magnitude(Z))
    want = harmonic_mask(Z, 1 / 3)
    for r, part in enumerate(slices):
        calls = []

        def bin_sum(buffer):
            calls.append(tuple(buffer.shape))
            return (total,)

        got = gathered_harmonic_mask(part, 1 / 3, bin_sum, (r * size, n_bins))
        real = max(0, min(size, n_bins - r * size))
        assert calls == [tuple(Z.shape)]
        assert torch.equal(got[..., :real, :], want[..., r * size:r * size + real, :])
        assert torch.all(got[..., real:, :] == 0)


def test_dryrun_multichip_takes_given_inputs():
    """The dry run on inputs and a depth the caller gives: HVA and FastGaussMNMF at 40 bins over 2 gloo ranks for 3
    steps, held on the relative measure against world size 1 (it raises on a miss)."""
    from ssspy_tpu_torch.parallel.dryrun import dryrun_multichip, make_inputs

    inputs = {name: make_inputs(name, n_bins=40) for name in ("hva", "fast_mnmf")}
    report = dryrun_multichip(2, device="cpu", names=tuple(inputs), inputs=inputs, n_iter=3, rel_tol=1e-4)
    for name in inputs:
        got = report["cases"][name]
        assert got["shapes"][0][1] == 40 and got["tol"] == 1e-4
        assert got["bin_sum_calls"] == 3 * CASES[name].pin
