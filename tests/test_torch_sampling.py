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
    # At top_p == 1.0 both sides run without the nucleus filter here: on these rows the
    # fp32 cumsum reaches 1.0 at a point that depends on the summation order, which
    # differs between the frameworks. test_top_p_one_masks_what_jax_masks holds the
    # filter at 1.0 on a row where that point does not depend on the order.
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
    support = torch.isfinite(tgen.filtered_logits(x, temperature, top_p, top_k))
    for seed in range(40):
        tok = tgen.sampling_core(x, torch.Generator().manual_seed(seed), temperature,
                                 top_p, top_k)
        assert tok.shape == (x.shape[0],)
        assert support[torch.arange(x.shape[0]), tok].all()
        again = tgen.sampling_core(x, torch.Generator().manual_seed(seed), temperature,
                                   top_p, top_k)
        assert torch.equal(tok, again)


def _saturating_row(V=64):
    """One logit far above a long tail: each tail probability is below 2**-25, so the
    fp32 cumulative sum is exactly 1.0 from the first token on, in any summation
    order — the nucleus filter at top_p = 1.0 then keeps the best token only."""
    row = np.zeros((1, V), np.float32)
    row[0, 7] = 30.0  # exp(-30) ~ 9.4e-14 < 2**-25
    row[0, 20:] = -1.0
    return row


def test_top_p_one_masks_what_jax_masks():
    """At top_p = 1.0 the nucleus filter runs, as in the JAX engine, and masks exactly
    the tokens JAX masks; the draw lands only on what is left."""
    x = _saturating_row()
    want = np.asarray(jgen.filtered_logits(jnp.asarray(x), 1.0, 1.0, 0))
    got = tgen.filtered_logits(torch.from_numpy(x), 1.0, 1.0, 0).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(want).sum() == 1 and np.isfinite(want[0, 7])
    for seed in range(20):
        tok = tgen.sampling_core(torch.from_numpy(x), torch.Generator().manual_seed(seed),
                                 1.0, 1.0, 0)
        assert int(tok[0]) == 7
    # With the filter off, every tail token stays live (and a draw may take one).
    assert np.isfinite(tgen.filtered_logits(torch.from_numpy(x), 1.0, 1.0, 0,
                                            apply_top_p=False).numpy()).all()


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
