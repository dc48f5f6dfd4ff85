"""The generated display LUT (ops/tonemap.generated_lut)."""

import jax.numpy as jnp
import numpy as np

from prosper_tpu.ops.tonemap import (
    LUT_DIMS,
    generated_lut,
    tone_map,
    tony_mc_mapface,
)


def test_generated_lut_layout():
    lut = generated_lut()
    assert lut.shape == (LUT_DIMS ** 3, 24) and lut.dtype == np.float32
    assert lut.min() == 0.0 and lut.max() == 1.0


def test_generated_lut_is_identity_in_encoded_space():
    """The LUT maps each encoded stimulus to itself, so the display curve
    is x / (1 + x) per channel."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 20, (1000, 3)).astype(np.float32)
    got = np.asarray(tony_mc_mapface(jnp.asarray(generated_lut()),
                                     jnp.asarray(x)))
    np.testing.assert_allclose(got, x / (1 + x), atol=2e-6)


def test_tone_map_is_monotone_and_bounded():
    ramp = jnp.linspace(0.0, 50.0, 256)[:, None] * jnp.ones((1, 3))
    out = np.asarray(tone_map(ramp, jnp.asarray(generated_lut())))
    assert (np.diff(out[:, 0]) >= 0).all()
    assert out.min() >= 0.0 and out.max() < 1.0
