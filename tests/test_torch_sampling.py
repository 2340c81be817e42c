"""The port's sampling against the JAX package's, on the CPU.

``filtered_logits`` must keep exactly the JAX support (temperature, top-k, top-p) with
the same values up to fp32 rounding; draws (Gumbel-max from a torch generator) must
land only in that support, be reproducible per generator seed, and follow the
filtered distribution.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu_torch import generation as tgen

SETTINGS = [  # (temperature, top_p, top_k)
    (0.7, 1.0, 0),
    (1.0, 1.0, 5),
    (0.9, 0.8, 0),
    (1.3, 0.9, 10),
    (0.5, 0.3, 3),
]


def _logits(seed=0, shape=(6, 50)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


@pytest.mark.parametrize("temperature,top_p,top_k", SETTINGS)
def test_filtered_logits_match_jax(temperature, top_p, top_k):
    x = _logits()
    # top_p == 1.0 means "no nucleus filter" (the port's draw skips it); applied at
    # 1.0 the filter's cumsum can round to 1.0 and mask a tail token depending on
    # summation order, so both sides skip it there.
    nucleus = top_p < 1.0
    want = np.asarray(jgen.filtered_logits(jnp.asarray(x), temperature, top_p, top_k,
                                           apply_top_p=nucleus))
    got = tgen.filtered_logits(torch.from_numpy(x), temperature, top_p, top_k,
                               apply_top_p=nucleus).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = np.isfinite(want)
    # The same division by the temperature on both sides: fp32 rounding only.
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


@pytest.mark.parametrize("temperature,top_p,top_k", SETTINGS)
def test_draws_stay_in_support_and_reproduce(temperature, top_p, top_k):
    x = torch.from_numpy(_logits(1))
    support = torch.isfinite(tgen.filtered_logits(x, temperature, top_p, top_k,
                                                  apply_top_p=top_p < 1.0))
    for seed in range(40):
        tok = tgen.sampling_core(x, torch.Generator().manual_seed(seed), temperature,
                                 top_p, top_k)
        assert tok.shape == (x.shape[0],)
        assert support[torch.arange(x.shape[0]), tok].all()
        again = tgen.sampling_core(x, torch.Generator().manual_seed(seed), temperature,
                                   top_p, top_k)
        assert torch.equal(tok, again)


def test_draws_follow_the_filtered_distribution():
    """4000 draws from one row: every kept token's frequency within 4 standard
    errors of its softmax probability."""
    x = torch.from_numpy(_logits(2, (1, 12)))
    probs = torch.softmax(tgen.filtered_logits(x, 1.0, 1.0, 6), dim=-1)[0]
    g = torch.Generator().manual_seed(0)
    n = 4000
    counts = torch.bincount(torch.cat([tgen.sampling_core(x, g, 1.0, 1.0, 6)
                                       for _ in range(n)]), minlength=12).double()
    freq = counts / n
    se = torch.sqrt(probs.double() * (1 - probs.double()) / n)
    assert (counts[probs == 0] == 0).all()
    assert ((freq - probs.double()).abs() <= 4 * se + 1e-12).all()


def test_emission_generator_schedule():
    """Emission i of a request seeded s always gets the same generator state, and
    neighbouring emissions or seeds get different ones."""
    a = tgen.emission_generator(5, 3).initial_seed()
    assert a == tgen.emission_generator(5, 3).initial_seed()
    assert a != tgen.emission_generator(5, 4).initial_seed()
    assert a != tgen.emission_generator(6, 3).initial_seed()
