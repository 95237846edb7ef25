"""The port's SimpleVAE against the flax model, after weight conversion.

Weights come from ``flax.init`` (random, seeded) plus random BatchNorm
statistics, go through ``tpuvae_torch.convert.simple_vae_from_flax``, and
both models take the same numpy inputs and reparameterisation noise.
Tolerance atol 1e-5: fp32 Linear/BatchNorm with different summation and
normalisation order, on inputs of unit scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_vae():
    from flax import traverse_util

    from tpuvae.models import SimpleVAE

    model = SimpleVAE()
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 370)), jax.random.PRNGKey(2), train=False)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(4)
    for k in flat:       # non-trivial running statistics and affine params
        if k.startswith("batch_stats/") and k.endswith("/mean"):
            flat[k] = rng.normal(size=flat[k].shape).astype(np.float32) * 0.3
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, flat[k].shape).astype(np.float32)
        elif k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return model, variables, flat


def _port(flat):
    from tpuvae_torch.convert import simple_vae_from_flax
    from tpuvae_torch.models import SimpleVAE

    model = SimpleVAE()
    model.load_state_dict(simple_vae_from_flax(flat))
    return model.eval()


def test_latent_matches_flax(flax_vae):
    from tpuvae.models import SimpleVAE as FlaxVAE

    model, variables, flat = flax_vae
    x = np.random.default_rng(5).normal(size=(6, 370)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  method=FlaxVAE.latent))
    with torch.no_grad():
        got = _port(flat).latent(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_forward_with_given_noise_matches_flax(flax_vae):
    """Eval-mode forward with the same eps: flax draws its noise from
    jax.random, so the noise is fed to both as an array."""
    model, variables, flat = flax_vae
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 370)).astype(np.float32)
    eps = rng.normal(size=(4, 32)).astype(np.float32)

    def flax_forward(m, xx, e):
        mu, logvar = m.encode(xx, train=False)
        z = mu + e * jnp.exp(0.5 * logvar)
        return m.decode(z, train=False), mu, logvar, z

    want = model.apply(variables, jnp.asarray(x), jnp.asarray(eps),
                       method=flax_forward)
    with torch.no_grad():
        got = _port(flat)(torch.from_numpy(x), torch.from_numpy(eps))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_generator_noise_is_reproducible(flax_vae):
    _, _, flat = flax_vae
    port = _port(flat)
    x = torch.zeros((2, 370))
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    with torch.no_grad():
        a = port(x, generator=g1)[3]
        b = port(x, generator=g2)[3]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flax_conversion_roundtrip(flax_vae):
    from tpuvae_torch.convert import simple_vae_from_flax, simple_vae_to_flax

    _, _, flat = flax_vae
    sd = simple_vae_from_flax(flat)
    assert sd["encoder.dense.0.weight"].shape == (128, 370)
    assert sd["fc_mu.weight"].shape == (32, 32)
    back = simple_vae_to_flax(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError):
        simple_vae_from_flax({"params/nope/kernel": np.zeros((2, 2))})


def test_batchnorm_matches_flax_defaults():
    from tpuvae_torch.models import MLPBlock

    block = MLPBlock(8, (4,), dropout=0.2)
    assert block.norm[0].eps == 1e-5
    assert block.norm[0].momentum == pytest.approx(0.01)
