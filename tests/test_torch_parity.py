"""Full-model numerical parity vs an independently-written torch mirror of
the reference VAE architecture (lunar_generate.py:84-291), with weights
converted through utils.torch_compat. Pins the BASELINE.json north-star
guarantee: decoded sprites match the PyTorch reference within per-pixel
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as tF

from lunaris_orion_tpu.config import VAEConfig
from lunaris_orion_tpu.models import vae as jvae
from lunaris_orion_tpu.utils.torch_compat import vae_params_from_torch
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

CFG = VAEConfig(latent_dim=24, image_size=32, base_channels=16)


# --- compact torch mirror of the reference architecture -------------------

def _res(cin, cout):
    class R(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1),
                                       nn.GroupNorm(8, cout), nn.Mish())
            self.conv2 = nn.Sequential(nn.Conv2d(cout, cout, 3, padding=1),
                                       nn.GroupNorm(8, cout), nn.Mish())
            self.shortcut = (nn.Conv2d(cin, cout, 1) if cin != cout
                             else nn.Identity())

        def forward(self, x):
            return tF.mish(self.conv2(self.conv1(x)) + self.shortcut(x))
    return R()


def _down(cin, cout):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride=2, padding=1),
                         nn.GroupNorm(8, cout), nn.Mish(), _res(cout, cout))


def _up(cin, cout):
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1),
                         nn.GroupNorm(8, cout), nn.Mish())


class TorchMirrorVAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.channels
        enc = nn.Module()
        cin = 3
        for i, c in enumerate(ch):
            setattr(enc, f"down{i + 1}", _down(cin, c))
            cin = c
        enc.fc_mu = nn.Linear(cfg.bottleneck_dim, cfg.latent_dim)
        enc.fc_logvar = nn.Linear(cfg.bottleneck_dim, cfg.latent_dim)
        self.encoder = enc
        dec = nn.Module()
        dec.fc = nn.Linear(cfg.latent_dim, cfg.bottleneck_dim)
        n = len(ch)
        head = max(cfg.base_channels // 2, 8)
        for i in range(n):
            cout = ch[n - 2 - i] if i < n - 1 else head
            setattr(dec, f"up{i + 1}", _up(ch[n - 1 - i], cout))
        dec.final_conv = nn.Conv2d(head, 3, 3, padding=1)
        self.decoder = dec
        self.cfg = cfg

    def forward(self, x):
        skips = []
        n = len(self.cfg.channels)
        for i in range(n):
            x = getattr(self.encoder, f"down{i + 1}")(x)
            if i < n - 1:
                skips.append(x)
        flat = x.flatten(1)
        mu = self.encoder.fc_mu(flat)
        z = mu  # deterministic: z = mu for parity
        h = self.decoder.fc(z).view(
            -1, self.cfg.channels[-1], self.cfg.bottleneck_hw,
            self.cfg.bottleneck_hw)
        for i in range(n):
            h = getattr(self.decoder, f"up{i + 1}")(h)
            j = n - 2 - i
            if 0 <= j < len(skips):
                h = h + skips[j]
        return torch.tanh(self.decoder.final_conv(h)), mu, \
            self.encoder.fc_logvar(flat)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    tmodel = TorchMirrorVAE(CFG).eval()
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    jparams = vae_params_from_torch(sd, CFG)
    return tmodel, jparams


class TestFullModelParity:
    def test_forward_recon_mu_logvar(self, pair):
        tmodel, jparams = pair
        x = np.random.default_rng(0).uniform(
            -1, 1, (2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            t_rec, t_mu, t_lv = tmodel(torch.tensor(x.transpose(0, 3, 1, 2)))
        j_rec, j_mu, j_lv = jvae.apply(jparams, jnp.asarray(x), rng=None,
                                       cfg=CFG, sample_posterior=False)
        np.testing.assert_allclose(np.asarray(j_mu), t_mu.numpy(),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(j_lv), t_lv.numpy(),
                                   rtol=1e-3, atol=1e-4)
        # per-pixel decode tolerance (north star): <1/255 everywhere
        np.testing.assert_allclose(
            np.asarray(j_rec), t_rec.permute(0, 2, 3, 1).numpy(),
            atol=1.0 / 255.0)

    def test_prior_decode_parity(self, pair):
        """Skip-free decode (sample path) matches torch decode of same z."""
        tmodel, jparams = pair
        z = np.random.default_rng(1).normal(
            size=(3, CFG.latent_dim)).astype(np.float32)
        with torch.no_grad():
            h = tmodel.decoder.fc(torch.tensor(z)).view(
                3, CFG.channels[-1], CFG.bottleneck_hw, CFG.bottleneck_hw)
            for i in range(CFG.num_down):
                h = getattr(tmodel.decoder, f"up{i + 1}")(h)
            t_img = torch.tanh(tmodel.decoder.final_conv(h))
        j_img = jvae.decode(jparams["decoder"], jnp.asarray(z), [], CFG)
        np.testing.assert_allclose(
            np.asarray(j_img), t_img.permute(0, 2, 3, 1).numpy(),
            atol=1.0 / 255.0)

    def test_losses_parity(self, pair):
        """recon MSE + KL computed on identical forwards match torch."""
        from lunaris_orion_tpu.train.losses import recon_kl
        tmodel, jparams = pair
        x = np.random.default_rng(2).uniform(
            -1, 1, (2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            t_rec, t_mu, t_lv = tmodel(torch.tensor(x.transpose(0, 3, 1, 2)))
            t_recon = tF.mse_loss(t_rec, torch.tensor(x.transpose(0, 3, 1, 2)))
            t_kl = -0.5 * torch.mean(1 + t_lv - t_mu.pow(2) - t_lv.exp())
        j_rec, j_mu, j_lv = jvae.apply(jparams, jnp.asarray(x), rng=None,
                                       cfg=CFG, sample_posterior=False)
        j_recon, j_kl = recon_kl(j_rec, jnp.asarray(x), j_mu, j_lv)
        np.testing.assert_allclose(float(j_recon), float(t_recon),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(j_kl), float(t_kl),
                                   rtol=1e-3, atol=1e-5)


class TestCheckpointFileLoader:
    def test_load_torch_pt_file(self, pair, tmp_path):
        """load_torch_checkpoint reads the reference's .pt layout
        (train_hybrid.py:594-615: dict with vae_state_dict)."""
        from lunaris_orion_tpu.utils.torch_compat import load_torch_checkpoint
        tmodel, jparams = pair
        ckpt = {"global_step": 7, "vae_state_dict": tmodel.state_dict(),
                "best_loss": 0.5}
        path = tmp_path / "latest.pt"
        torch.save(ckpt, path)
        params = load_torch_checkpoint(str(path), CFG)
        a = jax.tree_util.tree_leaves(params)
        b = jax.tree_util.tree_leaves(jparams)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
