"""rec_tpu_torch's MNIST VAE family vs rec_tpu on JAX-CPU: the four VAEs'
forward passes and ``SNISDistribution`` with converted weights and JAX's
draws fed in, the converter both ways, one ``make_vae_train_step`` against
rec_tpu's, ``train_generative_model model=vae`` in both packages with
checkpoints restored across them, and ``mnist_emp_bayes`` for every prior,
at small widths (latents 6, hidden 16, a few components).

Tolerances (float32, the same operations in another order): forward
outputs to rtol 1e-4 / atol 1e-3 on sums over 784 pixels or K components
(measured: log-likelihood 3.1e-4 absolute of ~540, KL 3.8e-6),
per-element outputs to atol 1e-5 (measured 4.8e-7)."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rec_tpu.models import mnist_vae as jm
from rec_tpu.parallel import mesh as jmesh
from rec_tpu.train import CheckpointManager as JCheckpointManager
from rec_tpu.train import init_state as j_init_state
from rec_tpu.train.lossless import LosslessTrainConfig as JTrainConfig
from rec_tpu.train.lossless import make_vae_train_step as j_make_step
from rec_tpu_torch.cli import mnist_emp_bayes as temp
from rec_tpu_torch.cli import train_generative_model as tcli
from rec_tpu_torch.models import mnist_convert
from rec_tpu_torch.models import mnist_vae as tm
from rec_tpu_torch.train import CheckpointManager as TCheckpointManager
from rec_tpu_torch.train import init_state as t_init_state
from rec_tpu_torch.train import make_optimizer as t_make_optimizer
from rec_tpu_torch.train.lossless import LosslessTrainConfig as TTrainConfig
from rec_tpu_torch.train.lossless import make_vae_train_step as t_make_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, B = 6, 16, 4
RTOL, ATOL = 1e-4, 1e-3     # sums over pixels / components
ELEM_ATOL = 1e-5            # per-element outputs (probabilities, locs)

MODELS = {
    "gaussian": (lambda: jm.MNISTVAE(latents=L, hidden_size=H),
                 lambda: tm.MNISTVAE(L, H, device="cpu")),
    "vamp": (lambda: jm.MNISTVampVAE(latents=L, hidden_size=H,
                                     num_vamp_components=5),
             lambda: tm.MNISTVampVAE(L, H, 5, device="cpu")),
    "mog": (lambda: jm.MNISTMoGVAE(latents=L, hidden_size=H,
                                   num_components=7),
            lambda: tm.MNISTMoGVAE(L, H, 7, device="cpu")),
    "snis": (lambda: jm.MNISTSNISVAE(latents=L, hidden_size=H, snis_K=9,
                                     snis_hidden=5),
             lambda: tm.MNISTSNISVAE(L, H, 9, 5, device="cpu")),
}


def _images(seed=0, n=B):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 28, 28, 1) > 0.5).astype(np.float32)


def _init(jmodel, x):
    rngs = {"params": jax.random.PRNGKey(0), "snis": jax.random.PRNGKey(2)}
    return jmodel.init(rngs, jnp.asarray(x), jax.random.PRNGKey(1))


class _Recorder:
    """Wraps jax.random.normal and keeps the draws of one shape (the SNIS
    bound's proposals inside a flax apply)."""

    def __init__(self, shape):
        self.shape, self.draws = shape, []
        self.normal = jax.random.normal

    def __call__(self, key, shape=(), *args, **kw):
        out = self.normal(key, shape, *args, **kw)
        if tuple(shape) == self.shape:
            self.draws.append(np.array(out))
        return out


def _jax_forward(name, jmodel, params, x, key, monkeypatch):
    """rec_tpu's outputs, its posterior noise and (snis) the proposals."""
    rec = _Recorder((jmodel.snis_K - 1, L) if name == "snis" else None)
    monkeypatch.setattr(jax.random, "normal", rec)
    rngs = {"snis": jax.random.PRNGKey(3)} if name == "snis" else None
    out = jmodel.apply(params, jnp.asarray(x), key, rngs=rngs)
    monkeypatch.undo()
    eps = np.array(jax.random.normal(key, (x.shape[0], L)))
    return out, eps, (rec.draws[0] if rec.draws else None)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name, monkeypatch):
    x = _images()
    jmodel, make = MODELS[name][0](), MODELS[name][1]
    params = _init(jmodel, x)
    model = make()
    mnist_convert.load_flax_params(model, jax.device_get(params))
    key = jax.random.PRNGKey(5)
    want, eps, proposals = _jax_forward(name, jmodel, params, x, key,
                                        monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(eps),
                    None if proposals is None
                    else torch.from_numpy(proposals))
    np.testing.assert_allclose(got["posterior"].loc.numpy(),
                               np.asarray(want["posterior"].loc),
                               atol=ELEM_ATOL)
    np.testing.assert_allclose(got["posterior"].scale.numpy(),
                               np.asarray(want["posterior"].scale),
                               atol=ELEM_ATOL)
    np.testing.assert_allclose(got["latent"].numpy(),
                               np.asarray(want["latent"]), atol=ELEM_ATOL)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               atol=ELEM_ATOL)
    for k in ("kl", "log_likelihood"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_round_trip_is_exact(name):
    x = _images()
    params = jax.device_get(_init(MODELS[name][0](), x))
    model = MODELS[name][1]()
    mnist_convert.load_flax_params(model, params)
    back = mnist_convert.to_numpy_tree(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


class TestSNISDistribution:
    def _pair(self):
        jd = jm.SNISDistribution(dim=L, K=11, hidden=5)
        x = np.random.RandomState(3).randn(B, L).astype(np.float32)
        params = jd.init({"params": jax.random.PRNGKey(0),
                          "snis": jax.random.PRNGKey(1)}, jnp.asarray(x))
        td = tm.SNISDistribution(L, 11, 5)
        mnist_convert.load_flax_params(td, jax.device_get(params))
        return jd, td, params, x

    def test_lower_bound_matches_jax(self, monkeypatch):
        jd, td, params, x = self._pair()
        rec = _Recorder((10, L))
        monkeypatch.setattr(jax.random, "normal", rec)
        want = np.asarray(jd.apply(params, jnp.asarray(x),
                                   rngs={"snis": jax.random.PRNGKey(4)}))
        monkeypatch.undo()
        with torch.no_grad():
            got = td(torch.from_numpy(x), torch.from_numpy(rec.draws[0]))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    def test_sample_is_the_gumbel_argmax(self):
        jd, td, params, _ = self._pair()
        key = jax.random.PRNGKey(6)
        want = np.asarray(jd.apply(params, key, method=jd.sample))
        k1, k2 = jax.random.split(key)
        proposals = np.array(jax.random.normal(k1, (11, L)))
        gumbel = np.array(jax.random.gumbel(k2, (11,)))
        with torch.no_grad():
            got = td.sample_from(torch.from_numpy(proposals),
                                 torch.from_numpy(gumbel))
        np.testing.assert_array_equal(got.numpy(), want)
        with torch.no_grad():
            draw = td.sample(torch.Generator().manual_seed(0))
        assert draw.shape == (L,) and torch.isfinite(draw).all()


def test_vae_train_step_matches_jax():
    """One adam step of the MNIST VAE: loss, metrics and the updated
    parameters and EMA against rec_tpu's, with JAX's posterior noise."""
    x = _images(1)
    jmodel = jm.MNISTVAE(latents=L, hidden_size=H)
    params = _init(jmodel, x)
    host = jax.device_get(params)   # the jitted step donates its state
    cfg = dict(beta=0.7, lamb=0.0, ema_decay=0.9)
    tx = optax.adam(1e-3)
    jstate = j_init_state(params, tx, beta=0.7)
    key = jax.random.PRNGKey(11)
    jnew, jmet = j_make_step(jmodel, JTrainConfig(**cfg), tx, 784)(
        jstate, jnp.asarray(x), key)
    model = tm.MNISTVAE(L, H, device="cpu")
    mnist_convert.load_flax_params(model, host)
    topt = t_make_optimizer("adam", lambda s: 1e-3)
    state = t_init_state(model, topt, beta=0.7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, L))))
    new, met = t_make_step(model, TTrainConfig(**cfg), topt, 784)(
        state, torch.from_numpy(x), eps)
    assert new.step == 1
    for k in ("loss", "nll", "kl", "true_kl", "bpp", "elbo_bpd",
              "expected_max_kl"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(met["kl_per_block"].numpy(),
                               np.asarray(jmet["kl_per_block"]),
                               rtol=RTOL, atol=ELEM_ATOL)
    for which in ("params", "ema_params"):
        want = mnist_convert.from_numpy_tree(jax.device_get(
            getattr(jnew, which)))
        got = getattr(new, which)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                       atol=1e-6, err_msg=k)


def _load_reference_cli(tmp_path_factory):
    """examples/lossless/train_generative_model.py as a module, its
    compilation cache in a temporary directory and JAX's setting put
    back."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    old = os.environ.get("REC_TPU_COMPILATION_CACHE")
    old_dir = jax.config.jax_compilation_cache_dir
    os.environ["REC_TPU_COMPILATION_CACHE"] = cache
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_train_generative_model_vae",
            os.path.join(REPO, "examples", "lossless",
                         "train_generative_model.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        if old is None:
            os.environ.pop("REC_TPU_COMPILATION_CACHE")
        else:
            os.environ["REC_TPU_COMPILATION_CACHE"] = old
    return mod


class TestTrainCli:
    def _args(self, root, which, iters):
        return ["model=vae", "latent_size=6", "batch_size=4",
                f"iters={iters}", "log_freq=2", "dataset.synthetic_size=16",
                f"dataset.data_dir={root / 'data'}",
                f"model_save_dir={root / ('ckpt_' + which)}",
                f"log_dir={root / ('logs_' + which)}"]

    def test_defaults_match_the_reference(self, tmp_path_factory):
        ref = _load_reference_cli(tmp_path_factory)
        for argv in (["model=vae"], ["model=vae", "dataset.dataset=cifar10"],
                     ["model=vae", "learning_rate=0.1", "lamb=0.5"]):
            want = ref._model_defaults(ref.apply_overrides(ref.Config(),
                                                           argv), argv)
            got = tcli._model_defaults(tcli.apply_overrides(tcli.Config(),
                                                            argv), argv)
            for k in ("learning_rate", "lamb", "optimizer"):
                assert getattr(got, k) == getattr(want, k), (argv, k)
            assert (got.dataset.dataset, got.dataset.normalize) == (
                want.dataset.dataset, want.dataset.normalize)

    def test_train_resume_across_packages(self, tmp_path, tmp_path_factory,
                                          monkeypatch):
        """iters=4 log_freq=2 in both CLIs: the same logged scalars and
        checkpoint steps; each package then resumes the other's
        checkpoint to step 6."""
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        ref = _load_reference_cli(tmp_path_factory)
        monkeypatch.setattr(ref, "make_mesh", lambda: jmesh.make_mesh(1))
        ref.main(self._args(tmp_path, "jax", 4))
        stats = tcli.main(self._args(tmp_path, "torch", 4) + ["device=cpu"])
        assert stats["steps"] == 4 and not stats["restored"]
        assert all(np.isfinite(stats["loss"] + stats["elbo_bpd"]))
        logs = {}
        for which in ("jax", "torch"):
            with open(tmp_path / f"logs_{which}" / "metrics.jsonl") as f:
                logs[which] = [json.loads(line) for line in f]
        assert [r["step"] for r in logs["torch"]] == [
            r["step"] for r in logs["jax"]] == [0, 2]
        assert [set(r) for r in logs["torch"]] == [set(r)
                                                   for r in logs["jax"]]
        ckpts = {w: sorted(f for f in os.listdir(tmp_path / f"ckpt_{w}")
                           if f.endswith(".msgpack"))
                 for w in ("jax", "torch")}
        assert ckpts["torch"] == ckpts["jax"]
        # Swap the directories: each package resumes the other's step 4.
        os.rename(tmp_path / "ckpt_jax", tmp_path / "ckpt_tmp")
        os.rename(tmp_path / "ckpt_torch", tmp_path / "ckpt_jax")
        os.rename(tmp_path / "ckpt_tmp", tmp_path / "ckpt_torch")
        more = tcli.main(self._args(tmp_path, "torch", 6) + ["device=cpu"])
        assert more["restored"] and more["start_step"] == 4
        assert more["final_step"] == 6
        ref.main(self._args(tmp_path, "jax", 6))
        assert JCheckpointManager(str(tmp_path / "ckpt_jax")).latest_step \
            == 6
        # The port's step-6 file holds the parameters rec_tpu restores.
        raw = TCheckpointManager(str(tmp_path / "ckpt_torch"),
                                 convert=mnist_convert).restore_params()
        model = tm.MNISTVAE(6, device="cpu")
        mnist_convert.load_flax_params(model, raw["params"])


class TestEmpBayes:
    ARGS = ["--iters", "4", "--batch", "4", "--latents", "5", "--hidden",
            "8", "--log-every", "2", "--device", "cpu"]

    @pytest.mark.parametrize("prior", sorted(temp.PRIORS))
    def test_trains_every_prior(self, prior):
        out = temp.main(self.ARGS + ["--prior", prior, "--max-kl", "1.0"])
        assert out["steps"] == 4 and out["nan_steps"] == 0
        assert np.isfinite(out["final_loss"])

    def test_skips_non_finite_steps_then_stops(self, monkeypatch):
        """A non-finite loss leaves the parameters as they were; past 50
        such steps the run stops."""
        kept = {}

        class NaNVAE(tm.MNISTVAE):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                kept.update({k: p.detach().clone()
                             for k, p in self.named_parameters()})
                kept["model"] = self

            def forward(self, x, eps, proposals=None):
                out = super().forward(x, eps, proposals)
                out["kl"] = out["kl"] * float("nan")
                return out

        monkeypatch.setitem(temp.PRIORS, "gaussian", NaNVAE)
        args = list(self.ARGS)
        args[1] = "60"
        out = temp.main(args)
        assert out["nan_steps"] == temp.MAX_NAN_STEPS + 1
        model = kept.pop("model")
        for k, p in model.named_parameters():
            assert torch.equal(p, kept[k]), k
