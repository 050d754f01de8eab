"""The batched LM calibration sweep of the PyTorch port (``parallel/sweep.py``).

On two perturbed BTC chains (bid and ask ivols scaled by 0.95 and 1.05, as
``tests/test_parallel.py`` scales them), on the CPU:

* each chain's LogSV fit in the sweep (2 LM iterations at 180 RK4 steps/yr,
  the port's LM parity setting) equals the port's single-chain
  ``calibrate_logsv_lm_on_device`` fit to 1e-10 relative, parameters and
  cost (measured 1.4e-15: vmap batches the same kernels);
* each chain's Heston fit (6 iterations) equals ``calibrate_heston_lm`` to
  1e-10 relative, and the JAX package's ``calibrate_heston_lm_sweep`` (run
  with a one-device mesh, so that nothing pads) to 1e-6, the JAX test's
  rtol (the LogSV sweep against the JAX package's:
  tests/test_torch_sweep_jax.py);
* a sweep longer than ``SWEEP_CHUNK`` runs in padded chunks, each chain's
  fit that of the unchunked sweep to 1e-10 (Heston) and 1e-12 (LogSV, one
  iteration);
* the chunks are of one size and pad fewer chains than there are chunks;
* a ``mesh`` that is not a ``PathMesh`` raises (a mesh splits the batch:
  tests/test_torch_mesh_sweep.py); chains of other maturities raise;
  ``pad_chains_to_sweep`` buckets as the JAX package's does;
* on a card (skipped here): the captured sweep equals its eager call bit
  for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
from _torch_port import cuda_device, svj, svt  # noqa: F401

from stochvolmodels_tpu.parallel import sweep as jsweep
from stochvolmodels_tpu.parallel.mesh import make_path_mesh
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.parallel import sweep as tsweep

SCALES = (0.95, 1.05)
LOGSV_P0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15, volvol=1.85)
HESTON_P0 = dict(v0=0.8 ** 2, theta=1.3 ** 2, kappa=4.0, volvol=1.5, rho=0.1)


def perturbed(package):
    base = package.get_btc_test_chain_data()
    return [dataclasses.replace(base, bid_ivs=[s * iv for iv in base.bid_ivs],
                                ask_ivs=[s * iv for iv in base.ask_ivs]) for s in SCALES]


def logsv_vector(p):
    return [p.sigma0, p.theta, p.kappa1, p.beta, p.volvol]


def heston_vector(p):
    return [p.v0, p.theta, p.kappa, p.rho, p.volvol]


def test_logsv_sweep_equals_the_single_chain_fits():
    chains = perturbed(svt)
    p0 = svt.LogSvParams(**LOGSV_P0)
    results = tsweep.calibrate_logsv_lm_sweep(chains, p0, nb_iters=2, year_steps=180,
                                              device="cpu")
    assert len(results) == 2
    for chain, (fit, cost) in zip(chains, results):
        single, single_cost = svt.calibrate_logsv_lm_on_device(chain, p0, nb_iters=2,
                                                               year_steps=180, device="cpu")
        np.testing.assert_allclose(logsv_vector(fit), logsv_vector(single), rtol=1e-10)
        np.testing.assert_allclose(cost, single_cost, rtol=1e-10)
    assert results[0][0].sigma0 < results[1][0].sigma0


def test_heston_sweep_equals_the_single_chain_fits_and_the_jax_sweep():
    chains = perturbed(svt)
    p0 = svt.HestonParams(**HESTON_P0)
    results = tsweep.calibrate_heston_lm_sweep(chains, p0, nb_iters=6, device="cpu")
    ref = jsweep.calibrate_heston_lm_sweep(perturbed(svj), svj.HestonParams(**HESTON_P0),
                                           nb_iters=6, use_float32=False,
                                           mesh=make_path_mesh(jax.devices()[:1]))
    for chain, (fit, cost), (jfit, jcost) in zip(chains, results, ref):
        single, single_cost = svt.calibrate_heston_lm(chain, p0, nb_iters=6, device="cpu")
        np.testing.assert_allclose(heston_vector(fit), heston_vector(single), rtol=1e-10)
        np.testing.assert_allclose(cost, single_cost, rtol=1e-10)
        np.testing.assert_allclose(heston_vector(fit), heston_vector(jfit), rtol=1e-6)
        np.testing.assert_allclose(cost, jcost, rtol=1e-6)
    assert results[1][0].v0 > results[0][0].v0


def test_a_sweep_longer_than_a_chunk_runs_in_padded_chunks(monkeypatch):
    """three chains in chunks of two (the last padded with a copy) give each
    chain the fit of the unchunked sweep."""
    base = svt.get_btc_test_chain_data()
    chains = [dataclasses.replace(base, bid_ivs=[s * iv for iv in base.bid_ivs],
                                  ask_ivs=[s * iv for iv in base.ask_ivs])
              for s in (0.95, 1.0, 1.05)]
    p0 = svt.HestonParams(**HESTON_P0)
    whole = tsweep.calibrate_heston_lm_sweep(chains, p0, nb_iters=2, device="cpu")
    monkeypatch.setattr(tsweep, "SWEEP_CHUNK", 2)
    chunked = tsweep.calibrate_heston_lm_sweep(chains, p0, nb_iters=2, device="cpu")
    assert len(chunked) == 3
    for (a, ca), (b, cb) in zip(chunked, whole):
        np.testing.assert_allclose(heston_vector(a) + [ca], heston_vector(b) + [cb], rtol=1e-10)


def test_a_logsv_sweep_in_chunks_equals_the_unchunked_sweep(monkeypatch):
    """three chains in chunks of two (the last padded with a copy of its
    chain), one iteration at 24 RK4 steps/yr, give each chain the fit of
    the unchunked vmapped sweep to 1e-12."""
    base = svt.get_btc_test_chain_data()
    chains = [dataclasses.replace(base, bid_ivs=[s * iv for iv in base.bid_ivs],
                                  ask_ivs=[s * iv for iv in base.ask_ivs])
              for s in (0.9, 1.0, 1.1)]
    p0 = svt.LogSvParams(**LOGSV_P0)
    kw = dict(nb_iters=1, year_steps=24, device="cpu")
    whole = tsweep.calibrate_logsv_lm_sweep(chains, p0, **kw)
    monkeypatch.setattr(tsweep, "SWEEP_CHUNK", 2)
    chunked = tsweep.calibrate_logsv_lm_sweep(chains, p0, **kw)
    assert len(chunked) == 3
    for (a, ca), (b, cb) in zip(chunked, whole):
        np.testing.assert_allclose(logsv_vector(a) + [ca], logsv_vector(b) + [cb], rtol=1e-12)


@pytest.mark.parametrize("n, chunk, size", [(3, 2, 2), (5, 2, 2), (4096, 4096, 4096),
                                            (4097, 4096, 2049), (10000, 4096, 3334)])
def test_chunks_are_equal_and_pad_less_than_a_chain_each(monkeypatch, n, chunk, size):
    """``n`` chains run in ceil(n / SWEEP_CHUNK) chunks of one size, at most
    SWEEP_CHUNK, padded by fewer chains than there are chunks."""
    monkeypatch.setattr(tsweep, "SWEEP_CHUNK", chunk)
    chunks = -(-n // chunk)
    assert tsweep._chunk_size(n) == size <= chunk
    assert -(-n // size) == chunks and 0 <= chunks * size - n < chunks


def test_a_mesh_raises_and_mixed_maturities_raise():
    chains = perturbed(svt)
    with pytest.raises(TypeError):
        tsweep.calibrate_logsv_lm_sweep(chains, svt.LogSvParams(**LOGSV_P0), mesh=object(),
                                        device="cpu")
    with pytest.raises(TypeError):
        tsweep.calibrate_heston_lm_sweep(chains, svt.HestonParams(**HESTON_P0), mesh=object(),
                                         device="cpu")
    short = svt.OptionChain.get_slices_as_chain(chains[0], ids=list(chains[0].ids[:2]))
    with pytest.raises(ValueError):
        tsweep.calibrate_logsv_lm_sweep([chains[0], short], svt.LogSvParams(**LOGSV_P0),
                                        device="cpu")
    assert tsweep.calibrate_heston_lm_sweep([], svt.HestonParams(**HESTON_P0), device="cpu") == []


def test_pad_chains_to_sweep_buckets_as_the_jax_package():
    def mixed(package):
        base = package.get_btc_test_chain_data()
        ids = list(base.ids)
        return [base, package.OptionChain.get_slices_as_chain(base, ids=ids[:2]), base,
                package.OptionChain.get_slices_as_chain(base, ids=ids[1:]),
                package.OptionChain.get_slices_as_chain(base, ids=ids[:2])]

    ours = tsweep.pad_chains_to_sweep(mixed(svt))
    ref = jsweep.pad_chains_to_sweep(mixed(svj))
    assert [[i for i, _ in b] for b in ours] == [[i for i, _ in b] for b in ref] \
        == [[0, 2], [1, 4], [3]]
    np.testing.assert_array_equal(tsweep.HESTON_LOWER, jsweep.HESTON_LOWER)
    np.testing.assert_array_equal(tsweep.HESTON_UPPER, jsweep.HESTON_UPPER)


@pytest.mark.gpu
def test_captured_sweep_equals_eager_bit_for_bit(cuda_device):
    chains = perturbed(svt)
    p0 = svt.LogSvParams(**LOGSV_P0)
    kw = dict(nb_iters=2, year_steps=60, device=cuda_device)
    init, steps = graphs.REPLAYS["logsv_lm_sweep_init"], graphs.REPLAYS["logsv_lm_sweep_step"]
    captured = tsweep.calibrate_logsv_lm_sweep(chains, p0, **kw)
    assert graphs.REPLAYS["logsv_lm_sweep_init"] == init + 1
    assert graphs.REPLAYS["logsv_lm_sweep_step"] == steps + 2
    with graphs.eager():
        eager = tsweep.calibrate_logsv_lm_sweep(chains, p0, **kw)
    for (a, ca), (b, cb) in zip(captured, eager):
        assert logsv_vector(a) == logsv_vector(b) and ca == cb
