"""The port's Trainer against pasero_tpu's, step for step.

A small transformer (2+2 layers, width 64, as in tests/test_torch_model.py)
in float32 with dropout 0 starts from the same numpy weights in both
packages (a flat npz passed with --ckpt) and takes 5 updates of 2
micro-batches each (--virtual-dp-size 2) on the same 10 batches. The JAX
Trainer runs on one CPU device, as tests/test_parallel.py builds it.

Tolerances: per-step loss, nll and gnorm rtol 1e-4 (float32, summed in
another order). Parameters after 5 updates: atol 1e-5, except the attention
key biases, held to 2 x lr x updates. Their gradient is zero in exact
arithmetic (adding a constant to every key's score leaves the softmax as it
is), so what each framework computes for it is summation-order noise, and
Adam, dividing by sqrt(nu), turns noise into an update of up to lr in
either direction.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.config import TrainingConfig as JaxTrainingConfig
from pasero_tpu.models import Transformer as JaxTransformer
from pasero_tpu.parallel import make_mesh
from pasero_tpu.training import Trainer as JaxTrainer
from pasero_torch import checkpoints
from pasero_torch.config import TrainingConfig
from pasero_torch.models.transformer import Transformer
from pasero_torch.scripts.bench_decode import random_state
from pasero_torch.training import Trainer, shift_targets

VOCAB = 64
UPDATES = 5
LR = 1e-3
SMALL = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
             encoder_ffn_dim=128, decoder_ffn_dim=128,
             encoder_attention_heads=4, decoder_attention_heads=4,
             dropout=0.0)


def make_cfg(cls, tmp, ckpt):
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    cfg = cls("--data-dir", os.path.join(tmp, "data"), "-o",
              os.path.join(tmp, "model"), "-s", "de", "-t", "en",
              "--max-steps", str(UPDATES), "--valid-interval", "5",
              "--log-interval", "1", "--seed", "0", "--dropout", "0",
              "--virtual-dp-size", "2", "--lr", str(LR), "--warmup", "2",
              "--label-smoothing", "0.1", "--ckpt", ckpt)
    for k, v in SMALL.items():
        setattr(cfg.model_cfg, k, v)
    return cfg


def make_batch(seed):
    """One shape for all batches (the JAX Trainer compiles a step per
    shape); the padding differs from batch to batch."""
    rng = np.random.default_rng(seed)
    B, S, T = 6, 11, 9
    src = rng.integers(4, VOCAB, (B, S)).astype(np.int32)
    src_mask = np.ones((B, S), bool)
    src_mask[1, S - 1 - seed % 4:] = False
    src[~src_mask] = 1
    dec = rng.integers(4, VOCAB, (B, T)).astype(np.int32)
    dec[:, 0] = 2
    target_mask = np.ones((B, T), bool)
    target_mask[2 + seed % 3, T - 1 - seed % 5:] = False
    dec[~target_mask] = 1
    return {"src_tokens": src, "src_mask": src_mask, "decoder_input": dec,
            "target_mask": target_mask, "prompt_mask": np.zeros((B, T), bool),
            "num_real_rows": B}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainer"))
    ckpt = os.path.join(tmp, "init.npz")
    cfg = make_cfg(TrainingConfig, os.path.join(tmp, "torch"), ckpt)
    model = Transformer(cfg.model_cfg, VOCAB, dtype=torch.float32)
    checkpoints.save_flat(ckpt, checkpoints.state_dict_to_params(
        random_state(model, 0)))
    batches = [make_batch(seed) for seed in range(2 * UPDATES)]

    trainer = Trainer(cfg, None, model, device="cpu")
    it = iter(batches)
    torch_logs = [trainer.train_step(it) for _ in range(UPDATES)]

    jcfg = make_cfg(JaxTrainingConfig, os.path.join(tmp, "jax"), ckpt)
    # with a prng_impl the JAX Trainer switches jax's process-wide default
    # PRNG, which later tests in this worker would inherit; dropout is 0
    jcfg.prng_impl = None
    jmodel = JaxTransformer(jcfg.model_cfg, src_vocab_size=VOCAB,
                            dtype=jnp.float32)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jcfg, task=None, model=jmodel, mesh=mesh)
    it = iter(batches)
    jax_logs = [jtrainer.train_step(it) for _ in range(UPDATES)]
    return trainer, torch_logs, jtrainer, jmodel, jax_logs, batches


def test_steps_match_jax(trained):
    trainer, torch_logs, jtrainer, _, jax_logs, _ = trained
    assert trainer.step == jtrainer.step == UPDATES
    for got, want in zip(torch_logs, jax_logs):
        for key in ("loss", "nll_loss", "gnorm"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert got["num_tokens"] == want["num_tokens"]
        assert (got["wpb"], got["bsz"]) == (want["wpb"], want["bsz"])


def test_parameters_after_updates_match_jax(trained):
    trainer, _, jtrainer, _, _, _ = trained
    want = jax_checkpoints.flatten_params(jtrainer.state.params)
    got = checkpoints.state_dict_to_params(trainer.model.state_dict())
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        atol = 2 * LR * UPDATES if key.endswith("k_proj/bias") else 1e-5
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol,
                                   err_msg=key)


def test_checkpoint_loads_in_jax(trained):
    """The port's checkpoint (model, optimizer, state) loads through
    pasero_tpu.checkpoints.load_params; the JAX model's logits on it match
    the port's within 1e-4."""
    trainer, _, jtrainer, jmodel, _, batches = trained
    path = trainer.save()
    model_dir = trainer.cfg.model_dir
    assert os.path.realpath(os.path.join(model_dir, "model_last.npz")) == \
        os.path.realpath(path)
    for name in (f"optimizer_{UPDATES}.npz", f"state_{UPDATES}.json"):
        assert os.path.exists(os.path.join(model_dir, name))
    params, missing, unexpected = jax_checkpoints.load_params(
        path, jtrainer.state.params)
    assert not missing and not unexpected
    batch = batches[0]
    logits_j = jmodel.apply({"params": params},
                            src_tokens=jnp.asarray(batch["src_tokens"]),
                            src_mask=jnp.asarray(batch["src_mask"]),
                            decoder_input=jnp.asarray(batch["decoder_input"])
                            )["logits"]
    trainer.model.eval()
    with torch.no_grad():
        logits_t = trainer.model(
            torch.from_numpy(batch["src_tokens"]),
            torch.from_numpy(batch["decoder_input"]),
            src_mask=torch.from_numpy(batch["src_mask"]))["logits"]
    assert np.abs(np.asarray(logits_j) - logits_t.numpy()).max() <= 1e-4


def test_resume_restores_optimizer_and_step(trained, tmp_path):
    """A Trainer built on the model directory resumes from model_last with
    the optimizer state and step of the save."""
    trainer = trained[0]
    trainer.save()
    cfg = trainer.cfg
    model = Transformer(cfg.model_cfg, VOCAB, dtype=torch.float32)
    resumed = Trainer(cfg, None, model, device="cpu")
    assert resumed.step == resumed.loaded_step == UPDATES
    assert resumed.optimizer.count == trainer.optimizer.count
    for k in trainer.optimizer.mu:
        torch.testing.assert_close(resumed.optimizer.mu[k],
                                   trainer.optimizer.mu[k], rtol=0, atol=0)
        torch.testing.assert_close(resumed.params[k], trainer.params[k],
                                   rtol=0, atol=0)


def test_async_save_holds_the_step_it_was_taken_at(tmp_path, monkeypatch):
    """With --async-save on the CPU, the checkpoint holds the parameters and
    moments of the step it was taken at, although the next update changes
    the tensors in place before the writer runs (the writer is held back
    until that update is done)."""
    import threading
    ckpt = str(tmp_path / "init.npz")
    cfg = make_cfg(TrainingConfig, str(tmp_path), ckpt)
    cfg.async_save = True
    model = Transformer(cfg.model_cfg, VOCAB, dtype=torch.float32)
    checkpoints.save_flat(ckpt, checkpoints.state_dict_to_params(
        random_state(model, 0)))
    trainer = Trainer(cfg, None, model, device="cpu")
    batches = iter([make_batch(seed) for seed in range(4)])
    trainer.train_step(batches)
    want = {k: v.copy() for k, v in checkpoints.state_dict_to_params(
        trainer.model.state_dict()).items()}
    want_opt = {k: v.copy() for k, v in checkpoints.optimizer_to_flat(
        trainer.optimizer.state_dict()).items()}

    stepped = threading.Event()
    write = checkpoints.save_checkpoint

    def held_back(*args, **kwargs):
        stepped.wait(60)
        return write(*args, **kwargs)

    monkeypatch.setattr(checkpoints, "save_checkpoint", held_back)
    path = trainer.save()
    trainer.train_step(batches)
    stepped.set()
    trainer.finalize()
    assert trainer.step == 2
    got = checkpoints.load_flat(path)
    got_opt = checkpoints.load_optimizer_flat(cfg.model_dir, 1)
    moved = checkpoints.state_dict_to_params(trainer.model.state_dict())
    assert any(not np.array_equal(moved[k], want[k]) for k in want)
    assert sorted(got) == sorted(want) and sorted(got_opt) == sorted(want_opt)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], want_opt[k], err_msg=k)


def test_shift_targets():
    dec = torch.tensor([[2, 5, 6, 1], [2, 7, 1, 1]])
    assert shift_targets(dec, 1).tolist() == [[5, 6, 1, 1], [7, 1, 1, 1]]


@pytest.mark.parametrize("flag,item", [
    (("--tp-size", "2"), "A.12"), (("--dp-size", "2"), "A.12"),
    (("--fsdp",), "A.12"), (("--checkpoint-activations",), "A.8")])
def test_unported_training_options_name_their_roadmap_item(tmp_path, flag,
                                                           item):
    args = ["--data-dir", str(tmp_path), "-o", str(tmp_path / "model"),
            "-s", "de", "-t", "en", "--max-steps", "1", "--valid-interval",
            "1", "--log-interval", "1", *flag]
    cfg = TrainingConfig(*args)
    for k, v in SMALL.items():
        setattr(cfg.model_cfg, k, v)
    with pytest.raises(NotImplementedError, match=item):
        Trainer(cfg, None, Transformer(cfg.model_cfg, VOCAB), device="cpu")


def test_dropout_is_live_in_training_only():
    """Dropout (residual, attention, activation, embedding) draws from the
    generator the trainer sets, in training mode only; with rate 0 the
    training forward equals the evaluation forward. flax's Dropout keeps a
    value as x / (1 - rate)."""
    from pasero_torch.config import get_model_config_cls
    from pasero_torch.models.modules import Dropout
    cfg = get_model_config_cls("transformer")(strict=False, **SMALL)
    cfg.set_defaults("translation")
    cfg.dropout = cfg.attention_dropout = cfg.activation_dropout = 0.3
    model = Transformer(cfg, VOCAB, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    model.set_dropout_generator(gen)
    batch = make_batch(0)
    src, dec = (torch.from_numpy(batch[k]) for k in ("src_tokens",
                                                     "decoder_input"))
    targets = shift_targets(dec, 1)

    def loss():
        return model(src, dec, targets=targets)["loss_sum"].item()

    model.eval()
    assert loss() == loss()
    model.train()
    first, second = loss(), loss()
    assert first != second
    gen.manual_seed(0)
    assert loss() == first
    x = torch.ones(10000)
    kept = Dropout(0.25).train()
    kept.generator = torch.Generator().manual_seed(1)
    y = kept(x)
    assert set(y.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.02
    cfg.dropout = cfg.attention_dropout = cfg.activation_dropout = 0.0
    still = Transformer(cfg, VOCAB, dtype=torch.float32)
    still.load_state_dict(model.state_dict())
    with torch.no_grad():
        train = still.train()(src, dec, targets=targets)["loss_sum"]
        evaluate = still.eval()(src, dec, targets=targets)["loss_sum"]
    assert train.item() == evaluate.item()
