"""ssspy_tpu_torch.parallel, the (dp, bin) runners on torch.distributed, against the JAX package and themselves.

One gloo world per layout, (1, 2), (2, 1), (2, 2) and (1, 4), is spawned
once per module (tests/torch_parallel_worker.py: the ranks import no JAX)
and runs every runner of the slice in complex128 on the CPU, at 33 bins,
which no layout of 2 or 4 bin shards divides (the padding twins of
tests/parallel/test_sharding.py's ``*_pads_uneven_bins``), and IP1, ISS1
and GaussILRMA-IP1 also at the dry run's 257 bins. Each case per
(runner, layout) is held

- against the JAX package's unsharded batched step (``jax.vmap`` of its
  ``_sc`` step, as tests/parallel/test_sharding.py runs it, here in x64),
  within the JAX tests' tolerances: ILRMA padded against padded, as the
  JAX runner documents; dense GaussMNMF padded against unpadded, its
  ``bin_mask`` making padding exact;
- against the port's own runner at world size 1, relative 1e-10: only the
  order of the summations changes;
- on its all-reduces per iteration through the bin hook, against the JAX
  package's pins (tests/parallel/test_hlo_collectives.py:241-262), at a
  local batch of 1 (2 x 2) and 2 (1 x 2, 1 x 4).

Besides: every rank returns the whole result, the losses summed over the
bin group, the mask twin, the layout factorization, ``fast_auxiva_batch``
and the float32 dry run over 2 and 4 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssspy_tpu.parallel as jpar
from ssspy_tpu.fast import fast_auxiva_batch as jax_fast_auxiva_batch
from ssspy_tpu.ops.splitc import gauss_mnmf_step_sc
from ssspy_tpu_torch.fast import fast_auxiva, fast_auxiva_batch
from ssspy_tpu_torch.ops.ilrma_steps import ilrma_loss
from ssspy_tpu_torch.ops.iva_steps import iva_laplace_loss
from ssspy_tpu_torch.ops.mnmf_steps import gauss_mnmf_step
from ssspy_tpu_torch.parallel import layout_shape, make_layout
from ssspy_tpu_torch.parallel.collectives import all_reduce_sum
from ssspy_tpu_torch.parallel.dryrun import (
    CASES,
    N_STEPS,
    dryrun_multichip,
    padded_inputs,
    reference_case,
    spawn,
)
from ssspy_tpu_torch.utils import from_jax_state, planar_to_complex
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)

WORLDS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
NAMES = worker.WORLD_CASES  # the runners of tests/test_torch_parallel_runners.py run there
# the JAX tests' tolerances for each runner against its unsharded run (tests/parallel/test_sharding.py,
# __graft_entry__.py:144-268); IPA's is the JAX test's x64 one
JAX_TOL = {
    "ip1": 1e-5, "iss1": 1e-5, "cacgmm": 1e-5, "ilrma": 1e-4, "mnmf": 2e-3, "mnmf_partitioning": 2e-3,
    "ipsdta": 2e-3, "ip2": 5e-4, "iss2": 2e-4, "ipa": 1e-7, "wave": 1e-4,
}
SELF_TOL = 1e-10  # relative, complex128 against world size 1


@pytest.fixture(scope="module")
def world():
    """``world(key)``: the ranks' reports of the world ``WORLDS[key]``, spawned on first use."""
    cache = {}

    def get(key):
        if key not in cache:
            shape = WORLDS[key]
            cache[key] = spawn(shape[0] * shape[1], worker.run_world, (shape,), device="cpu", timeout=300)
        return cache[key]

    return get


def _planar(a):
    """Complex ``(B, ...)`` -> the JAX runners' planar ``(B, 2, ...)``."""
    a = np.asarray(a)
    return jnp.asarray(np.stack([a.real, a.imag], axis=1)) if np.iscomplexobj(a) else jnp.asarray(a)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _steps(step):
    def run(X, carry):
        for _ in range(N_STEPS):
            carry = step(X, carry)
        return carry

    return run


def _jax_run(name, inputs):
    """The JAX package's unsharded batched step, ``N_STEPS`` times, on ``inputs``; the port's layout of outputs."""
    if name == "wave":
        mesh = jpar.make_mesh(devices=jax.devices()[:1])
        return (np.asarray(jpar.make_batched_auxiva_wave_runner_sc(mesh, n_fft=256)(jnp.asarray(inputs[0]), N_STEPS)),)
    if name in ("iss1", "iss2", "ipa"):
        step = {"iss1": jpar.batched_auxiva_iss1_step_sc, "iss2": jpar.batched_auxiva_iss2_step_sc,
                "ipa": jpar.batched_auxiva_ipa_step_sc}[name]
        Y = _compiled(_steps(lambda _, Y: step(Y)), None, _planar(inputs[0]))
        return (from_jax_state({"Y": Y}, plane_axis=1)["Y"].numpy(),)
    if name in ("ip1", "ip2"):
        step = jpar.batched_auxiva_ip1_step_sc if name == "ip1" else jpar.batched_auxiva_ip2_step_sc
        W = _compiled(_steps(step), _planar(inputs[0]), _planar(inputs[1]))
        return (from_jax_state({"W": W}, plane_axis=1)["W"].numpy(),)
    X, carry = inputs
    keys = {
        "ilrma": ("W", "T", "V"), "mnmf": ("T", "V", "H"), "mnmf_partitioning": ("T", "V", "H", "Z"),
        "cacgmm": ("alpha", "B"), "ipsdta": ("W", "T_parts", "V"),
    }[name]
    if name == "ipsdta":
        carry = (carry[0], tuple(carry[1]), carry[2])
        step = jpar.batched_ipsdta_vcd_step_sc
    elif name.startswith("mnmf"):
        step = jax.vmap(lambda xx, c: gauss_mnmf_step_sc(xx, *c), in_axes=(0, 0))
    else:
        step = {"ilrma": jpar.batched_gauss_ilrma_ip1_step_sc, "cacgmm": jpar.batched_cacgmm_step_sc}[name]
    jcarry = tuple(tuple(_planar(p) for p in leaf) if isinstance(leaf, tuple) else _planar(leaf) for leaf in carry)
    out = _compiled(_steps(step), _planar(X), jcarry)
    state = from_jax_state(
        {k: [np.asarray(p) for p in v] if k == "T_parts" else np.asarray(v) for k, v in zip(keys, out)}, plane_axis=1
    )
    return tuple(t.numpy() for k in keys for t in (state[k] if k == "T_parts" else [state[k]]))


@pytest.fixture(scope="module")
def jax_reference():
    """``jax_reference(name, shards, n_bins)``, computed once each (ILRMA's depends on the padding of ``shards``)."""
    cache = {}

    def get(name, shards, n_bins=worker.N_BINS):
        key = (name, shards if name == "ilrma" else 1, n_bins)
        if key not in cache:
            inputs = worker.inputs(name, n_bins)
            out = _jax_run(name, padded_inputs(name, inputs, shards))
            if name == "ilrma":  # padded against padded, then the real bins
                n_bins = inputs[0].shape[2]
                out = (out[0][:, :n_bins], out[1][:, :, :n_bins], out[2])
            cache[key] = out
        return cache[key]

    return get


@pytest.fixture(scope="module")
def world_one():
    cache = {}

    def get(name, shards):
        key = (name, shards if name == "ilrma" else 1)
        if key not in cache:
            cache[key] = tuple(o.numpy() for o in reference_case(name, worker.inputs(name), shards, "cpu"))
        return cache[key]

    return get


CASE_IDS = [(name, key) for name in NAMES for key in WORLDS]


@pytest.mark.parametrize("name,key", CASE_IDS, ids=[f"{n}-{k}" for n, k in CASE_IDS])
def test_runner_matches_jax_batched_step(world, jax_reference, name, key):
    got = world(key)[0]["cases"][name]["outputs"]
    ref = jax_reference(name, WORLDS[key][1])
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=JAX_TOL[name], rtol=0)


WIDE_IDS = [(name, key) for name in worker.WIDE for key in WORLDS]


@pytest.mark.parametrize("name,key", WIDE_IDS, ids=[f"{n}-257bins-{k}" for n, k in WIDE_IDS])
def test_runner_matches_jax_batched_step_at_257_bins(world, jax_reference, name, key):
    got = world(key)[0]["cases"][f"{name}@{worker.WIDE_BINS}"]["outputs"]
    ref = jax_reference(name, WORLDS[key][1], worker.WIDE_BINS)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=JAX_TOL[name], rtol=0)


@pytest.mark.parametrize("name,key", CASE_IDS, ids=[f"{n}-{k}" for n, k in CASE_IDS])
def test_runner_matches_world_one_complex128(world, world_one, name, key):
    got = world(key)[0]["cases"][name]["outputs"]
    ref = world_one(name, WORLDS[key][1])
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.abs(g - r).max() <= SELF_TOL * np.abs(r).max()


@pytest.mark.parametrize("name,key", CASE_IDS, ids=[f"{n}-{k}" for n, k in CASE_IDS])
def test_all_reduces_per_iteration_match_the_pins(world, name, key):
    """At local batch 1 (2 x 2) and 2 (1 x 2, 1 x 4) alike: one all-reduce carries every utterance's partials."""
    case = CASES[name]
    expected = 0 if WORLDS[key][1] == 1 else case.pin * N_STEPS + case.extra
    for rank in world(key):
        assert rank["cases"][name]["calls"] == expected


@pytest.mark.parametrize("key", WORLDS)
def test_every_rank_returns_the_global_result(world, key):
    reports = world(key)
    for rank in reports[1:]:
        for name in NAMES:
            for a, b in zip(rank["cases"][name]["outputs"], reports[0]["cases"][name]["outputs"]):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("key", WORLDS)
def test_losses_sum_over_the_bin_group(world, key):
    """``iva_laplace_loss`` and ``ilrma_loss`` on a rank's own bins, with the hook, give the loss of all bins."""
    X = torch.as_tensor(worker.inputs("ip1")[0][0])
    W = torch.as_tensor(world(key)[0]["cases"]["ip1"]["outputs"][0][0])
    want = float(iva_laplace_loss(X, W=W))
    Xi = torch.as_tensor(worker.inputs("ilrma")[0][0])
    Wi, Ti, Vi = (torch.as_tensor(o[0]) for o in world(key)[0]["cases"]["ilrma"]["outputs"])
    want_ilrma = float(ilrma_loss(Xi, Ti, Vi, W=Wi))
    for rank in world(key):
        assert rank["iva_loss"] == pytest.approx(want, rel=1e-12)
        assert rank["ilrma_loss"] == pytest.approx(want_ilrma, rel=1e-12)


@pytest.mark.parametrize("key", WORLDS)
def test_layout_makes_its_bin_groups_once(world, key):
    """A second layout of the same shape under the same process group reuses the first one's bin group."""
    for rank in world(key):
        assert rank["bin_group_reused"]


def test_layout_factorization():
    """Twin of tests/parallel/test_sharding.py:34-38."""
    assert layout_shape(8) == (2, 4)
    assert layout_shape(4) == (2, 2)
    assert layout_shape(2) == (1, 2)
    assert layout_shape(1) == (1, 1)
    assert layout_shape(8, shape=(4, 2)) == (4, 2)
    with pytest.raises(ValueError):
        layout_shape(4, shape=(3, 1))


def test_layout_without_a_process_group():
    layout = make_layout(device="cpu")
    assert layout.shape == (1, 1) and not layout.distributed and layout.bin_sum is None
    assert layout.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_layout(world_size=2, device="cpu")


def test_all_reduce_sum_takes_one_real_dtype():
    """complex64 travels with float32 only: a float64 partial beside it raises before any collective."""
    with pytest.raises(ValueError, match="one real dtype"):
        all_reduce_sum([torch.ones(3, dtype=torch.complex64), torch.ones(2, dtype=torch.float64)])


def test_ipsdta_t_model_takes_no_bin_hook():
    """The t model's frame weight sums over every bin: a sharded t-IPSDTA step raises before any collective."""
    from ssspy_tpu_torch.ops.ipsdta_steps import ipsdta_vcd_step
    from ssspy_tpu_torch.parallel.collectives import BinAllReduce

    X, (W, T_parts, V) = worker.inputs("ipsdta")
    with pytest.raises(ValueError, match="not sharded"):
        ipsdta_vcd_step(torch.as_tensor(X[0]), torch.as_tensor(W[0]), [torch.as_tensor(T_parts[0][0])],
                        torch.as_tensor(V[0]), dof=5.0, bin_sum=BinAllReduce(None, 2))


def _mnmf_fixture(seed, n_bins, n_channels=3, n_frames=8, n_basis=2):
    """tests/parallel/test_sharding.py:610-631 at one utterance, complex."""
    rng = np.random.default_rng(seed)
    Xc = rng.standard_normal((n_channels, n_bins, n_frames)) + 1j * rng.standard_normal((n_channels, n_bins, n_frames))
    XX = np.einsum("mit,nit->itmn", Xc, Xc.conj())
    T = rng.random((n_channels, n_bins, n_basis)) + 0.1
    V = rng.random((n_channels, n_basis, n_frames)) + 0.1
    H = np.tile(np.eye(n_channels), (n_channels, n_bins, 1, 1)) + 0.1 + 0j
    return XX, T, V, H


def test_gauss_mnmf_bin_mask_is_exactly_neutral():
    """Twin of tests/parallel/test_sharding.py:646-669: a masked zero-padded bin never perturbs the real bins."""
    XX, T, V, H = (torch.as_tensor(a) for a in _mnmf_fixture(31, 8))
    pad = 3
    XXp = torch.cat([XX, torch.zeros((pad,) + XX.shape[1:], dtype=XX.dtype)])
    Tp = torch.cat([T, torch.zeros(T.shape[0], pad, T.shape[2], dtype=T.dtype)], dim=1)
    Hp = torch.cat([H, torch.zeros(H.shape[0], pad, *H.shape[2:], dtype=H.dtype)], dim=1)
    mask = torch.arange(8 + pad) < 8
    ref, padded = (T, V, H), (Tp, V, Hp)
    for _ in range(3):
        ref = gauss_mnmf_step(XX, *ref)
        padded = gauss_mnmf_step(XXp, *padded, bin_mask=mask)
    np.testing.assert_allclose(padded[0][:, :8].numpy(), ref[0].numpy(), rtol=1e-12)
    np.testing.assert_allclose(padded[1].numpy(), ref[1].numpy(), rtol=1e-12)
    np.testing.assert_allclose(padded[2][:, :8].numpy(), ref[2].numpy(), rtol=1e-12)
    assert torch.all(padded[0][:, 8:] == 0) and torch.all(padded[2][:, 8:] == 0)

    # and the JAX masked step on the same padded inputs
    jout = (jnp.asarray(Tp.numpy()), jnp.asarray(V.numpy()), _planar(Hp.numpy()[None])[0])
    XXs = _planar(XXp.numpy()[None])[0]
    for _ in range(3):
        jout = gauss_mnmf_step_sc(XXs, *jout, bin_mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(padded[2].numpy(), planar_to_complex(np.asarray(jout[2])).numpy(), atol=1e-9)


def test_gauss_mnmf_step_without_mask_is_unchanged_by_an_all_true_mask():
    XX, T, V, H = (torch.as_tensor(a) for a in _mnmf_fixture(33, 6))
    a = gauss_mnmf_step(XX, T, V, H)
    b = gauss_mnmf_step(XX, T, V, H, bin_mask=torch.ones(6, dtype=torch.bool))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_from_jax_state_reads_batched_planar_carries():
    rng = np.random.default_rng(5)
    W = rng.standard_normal((2, 2, 5, 3, 3)).astype(np.float32)
    parts = [rng.standard_normal((2, 2, 3, 2, 4, 2, 2))]
    state = from_jax_state({"W": W, "T_parts": parts, "alpha": rng.random((2, 3, 5)), "B": W}, plane_axis=1)
    assert state["W"].shape == (2, 5, 3, 3) and state["W"].dtype == torch.complex64
    assert torch.equal(state["W"].real, torch.from_numpy(W[:, 0])) and torch.equal(state["W"].imag, torch.from_numpy(W[:, 1]))
    assert state["T_parts"][0].shape == (2, 3, 2, 4, 2, 2)
    assert state["alpha"].dtype == torch.float64 and state["B"].shape == (2, 5, 3, 3)
    with pytest.raises(ValueError):
        planar_to_complex(W, plane_axis=2)


def _spectrograms():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2, 3, 128, 40)) + 1j * rng.standard_normal((2, 3, 128, 40))).astype(np.complex64)


def test_fast_auxiva_batch_matches_jax():
    """Against the JAX ``fast_auxiva_batch`` (tests/test_fast.py:80-97) on its 8-device mesh."""
    X = _spectrograms()
    Y, W = fast_auxiva_batch(X, n_iter=4, device="cpu")
    Y_jax, W_jax = jax_fast_auxiva_batch(X, n_iter=4)
    assert Y.shape == X.shape and W.shape == (2, 128, 3, 3)
    np.testing.assert_allclose(Y.numpy(), Y_jax, atol=1e-4)
    np.testing.assert_allclose(W.numpy(), W_jax, atol=1e-4)


def test_fast_auxiva_batch_equals_fast_auxiva_per_utterance():
    """With no group the batch shares each iteration, and each utterance keeps ``fast_auxiva``'s bits on the CPU."""
    X = _spectrograms()
    Y, W = fast_auxiva_batch(X, n_iter=4, device="cpu")
    for b in range(X.shape[0]):
        Y_b, W_b = fast_auxiva(X[b], n_iter=4, device="cpu")
        assert torch.equal(Y[b], Y_b) and torch.equal(W[b], W_b)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_on_the_cpu(n_ranks):
    """The six state layouts in float32 at 257 bins over gloo ranks, each against world size 1 (it raises on a miss)."""
    report = dryrun_multichip(n_ranks, device="cpu")
    assert report["shape"] == layout_shape(n_ranks)
    assert set(report["cases"]) == {"ip1", "iss1", "ilrma", "mnmf", "cacgmm", "ipsdta"}
