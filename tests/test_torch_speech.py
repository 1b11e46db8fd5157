"""The port's speech path against pasero_tpu's, on the CPU.

- The log-mel frontend: the port's plain ``log_mel_spectrogram`` against
  JAX's plain route and its Pallas kernel in interpret mode (on 1 s of audio
  or less), atol and rtol 1e-4 as tests/test_mel.py holds them; the
  filterbank and DFT bases bit-equal to JAX's (the same numpy code).
- ``ConvolutionSubsampler`` against JAX's in float32 within 1e-5, with glu
  and gelu, with and without the input and output projections, and equal
  subsampled lengths.
- A small Whisper-style model (the whisper_base arch cut to 2 + 2 layers of
  width 64, 80 mel bins) on numpy-seeded weights in float32: encoder
  outputs and logits within 1e-4, greedy and beam-5 tokens and lengths
  identical to JAX's search functions on 16 synthesized utterances, scores
  within 1e-4; two Trainer updates against the JAX Trainer (loss, nll and
  gnorm rtol 1e-4, as tests/test_torch_trainer.py holds them).
- The checkpoint bridge carries flax Conv kernels (k, in, out) to
  ``conv1d``'s (out, in, k) and back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

import pasero_tpu.ops.mel as jmel
from pasero_tpu.config import TrainingConfig as JaxTrainingConfig
from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.decoding.search import beam_search as jax_beam_search
from pasero_tpu.decoding.search import sample_decode as jax_sample_decode
from pasero_tpu.models import Transformer as JaxTransformer
from pasero_tpu.models.modules import \
    ConvolutionSubsampler as JaxSubsampler
from pasero_tpu.parallel import make_mesh
from pasero_tpu.training import Trainer as JaxTrainer
from pasero_torch import checkpoints
from pasero_torch.config import TrainingConfig
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.decoding.search import NEG_INF, beam_search, sample_decode
from pasero_torch.models.modules import ConvolutionSubsampler
from pasero_torch.models.transformer import Transformer
from pasero_torch.ops import mel
from pasero_torch.testdata.synth_speech import synthesize
from pasero_torch.training import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_EN = os.path.join(ROOT, "examples", "deen-mini", "data", "test.en")
VOCAB = 97
MAX_NEW = 16
SMALL = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
             encoder_ffn_dim=128, decoder_ffn_dim=128,
             encoder_attention_heads=4, decoder_attention_heads=4,
             conv_channels=64, encoder_max_len=256, decoder_max_len=64,
             padding_idx=1, bos_idx=2, eos_idx=2, unk_idx=3, dropout=0.0)


def utterances(n: int, seed: int = 0) -> list:
    """float32 waveforms of the first ``n`` lines of deen-mini's test.en."""
    with open(TEST_EN) as f:
        lines = [next(f).strip() for _ in range(n)]
    return [synthesize(line, seed).astype(np.float32) / 32768.0
            for line in lines]


def torch_log_mel(audio: np.ndarray, **kw) -> np.ndarray:
    return mel.log_mel_spectrogram(torch.from_numpy(audio), **kw).numpy()


# -- the mel frontend ---------------------------------------------------------

def test_filterbank_and_bases_equal_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(mel.mel_filterbank(16000, 400, n_mels),
                                      jmel.mel_filterbank(16000, 400, n_mels))
    hann = torch.from_numpy(mel.hann_window(400))
    for got, want in zip(mel.window_bases(hann), jmel._dft_bases(400)):
        np.testing.assert_array_equal(got.numpy(), want)


def mel_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "noise_1s":
        return rng.normal(size=(2, 16000)).astype(np.float32)
    if kind == "ragged":
        return (0.1 * rng.normal(size=(1, 12345))).astype(np.float32)
    return utterances(1)[0][None]


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("kind", ["noise_1s", "ragged", "utterance"])
def test_log_mel_matches_jax(kind, n_mels):
    audio = mel_input(kind)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio),
                                               n_mels=n_mels))
    got = torch_log_mel(audio, n_mels=n_mels)
    assert got.shape == want.shape == (
        audio.shape[0], mel.num_frames(audio.shape[1], 400, 160), n_mels)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_log_mel_matches_jax_pallas_kernel():
    """JAX's Pallas kernel (interpret mode) on 1 s of noise."""
    audio = mel_input("noise_1s")[:1]
    jmel.INTERPRET = True
    try:
        want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio),
                                                   use_pallas=True))
    finally:
        jmel.INTERPRET = False
    np.testing.assert_allclose(torch_log_mel(audio), want, atol=1e-4,
                               rtol=1e-4)


def test_silence_sits_at_the_floor():
    """All-zero audio: every mel is 0, log10 floors at -10 and the clamp
    and scale give (-10 + 4) / 4 = -1.5 everywhere."""
    out = torch_log_mel(np.zeros((2, 4000), np.float32))
    assert out.shape == (2, 25, 80)
    assert (out == -1.5).all()


def test_clamp_is_per_utterance():
    """A loud utterance batched with a quiet one leaves the quiet one's
    features as they are alone."""
    loud, quiet = utterances(2)
    n = min(len(loud), len(quiet))
    both = np.stack([loud[:n], 1e-3 * quiet[:n]])
    alone = torch_log_mel(both[1:])
    np.testing.assert_allclose(torch_log_mel(both)[1], alone[0], atol=1e-6)


def test_power_mel_refuses_what_the_kernel_does_not_take():
    window, mel_w = mel._constants(16000, 400, 80, torch.device("cpu"))
    audio = torch.zeros(1, 1600)
    before = mel.power_mel.launches
    with pytest.raises(TypeError, match="float32"):
        mel.power_mel(audio.double(), window, mel_w)
    with pytest.raises(ValueError, match="too few"):
        mel.power_mel(audio[:, :100], window, mel_w)
    with pytest.raises(ValueError, match="do not agree"):
        mel.power_mel(audio, window[:-1], mel_w)
    # the CPU route is the plain version: no kernel launch
    out = mel.power_mel(audio, window, mel_w)
    assert out.shape == (1, 10, 80)
    assert mel.power_mel.launches == before


def factored_power(audio, window, n_fft, hop=160):
    """csrc/mel.cu's factored DFT in float64 torch, from the kernel's own
    twiddle table: P-point DFTs of the Q columns (k1 <= P / 2), conjugates
    for the rest, then Q twiddled products per bin. Returns (power,
    spectrum)."""
    P, Q = mel.KERNEL_FACTORS[n_fft]
    tw = mel._twiddles(n_fft, torch.device("cpu")).double()
    tw = torch.complex(tw[:, 0], tw[:, 1])
    frames = mel.frame_signal(audio.double(), n_fft, hop)[:, :-1]
    y = (frames * window.double()).reshape(*frames.shape[:-1], P, Q)
    n1, kk = torch.arange(P), torch.arange(P // 2 + 1)
    A = torch.einsum("btpq,pk->btqk", y.to(torch.complex128),
                     tw[(Q * n1[:, None] * kk[None]) % n_fft])
    k = torch.arange(n_fft // 2 + 1)
    k1 = k % P
    conj = k1 > P // 2
    Ak = A[..., torch.where(conj, P - k1, k1)]
    Ak = torch.where(conj, Ak.conj(), Ak)
    X = (Ak * tw[(torch.arange(Q)[:, None] * k[None]) % n_fft]).sum(-2)
    return X.real ** 2 + X.imag ** 2, X


@pytest.mark.parametrize("n_fft", sorted(mel.KERNEL_FACTORS))
def test_kernel_factoring_matches_dense_dft(n_fft):
    """The mel kernel's twiddle table and factoring: the factored DFT of
    every compiled n_fft equals the dense windowed DFT of the plain version
    (float64, relative 1e-6 of the spectrum's scale), with exact zero
    imaginary parts at bin 0 and the Nyquist bin."""
    tw = mel._twiddles(n_fft, torch.device("cpu"))
    assert tw[0].tolist() == [1.0, 0.0]
    assert tw[n_fft // 2].tolist() == [-1.0, 0.0]
    assert tw[n_fft // 4].tolist() == [0.0, -1.0]
    audio = torch.from_numpy(mel_input("noise_1s"))
    window = torch.from_numpy(mel.hann_window(n_fft).astype(np.float32))
    power, X = factored_power(audio, window, n_fft)
    cos_b, sin_b = mel.window_bases(window)
    frames = mel.frame_signal(audio.double(), n_fft, 160)[:, :-1]
    dense = (frames @ cos_b.double()) ** 2 + (frames @ sin_b.double()) ** 2
    np.testing.assert_allclose(power.numpy(), dense.numpy(), rtol=0,
                               atol=1e-6 * dense.max().item())
    assert (X.imag[..., 0] == 0).all() and (X.imag[..., -1] == 0).all()


def test_kernel_factoring_matches_jax_log_mel():
    """The factored power through the filterbank, log10, clamp and scale
    equals JAX's log_mel_spectrogram on an utterance."""
    audio = mel_input("utterance")
    window, mel_w = mel._constants(16000, 400, 80, torch.device("cpu"))
    power, _ = factored_power(torch.from_numpy(audio), window, 400)
    log_spec = torch.log10(torch.clamp(power @ mel_w.double(), min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2),
                                                     keepdim=True) - 8.0)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio)))
    np.testing.assert_allclose(((log_spec + 4.0) / 4.0).numpy(), want,
                               atol=1e-4, rtol=1e-4)


# -- the convolution subsampler -----------------------------------------------

@pytest.mark.parametrize("activation", ["glu", "gelu"])
@pytest.mark.parametrize("proj", [False, True])
def test_subsampler_matches_jax(activation, proj):
    F_in, channels = 16, 32
    kw = dict(channels=channels, kernel_sizes=[3, 5], strides=[1, 2],
              activation=activation, out_dim=40 if proj else None,
              in_proj_dim=24 if proj else None)
    jmod = JaxSubsampler(dtype=jnp.float32, **kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 21, F_in)).astype(np.float32)
    lengths = np.array([21, 13, 6], np.int32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(lengths))["params"]
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params)), sep="/")
    want, want_len = jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(lengths))
    tmod = ConvolutionSubsampler(F_in, dtype=torch.float32, **kw)
    tmod.load_state_dict(checkpoints.params_to_state_dict(flat))
    with torch.no_grad():
        got, got_len = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    assert hasattr(tmod, "in_proj") == hasattr(tmod, "out_proj") == proj
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


# -- a small Whisper-style model ----------------------------------------------

def configs():
    out = []
    for cls in (jax_config_cls("whisper_base"),
                torch_config_cls("whisper_base")):
        cfg = cls(strict=False, **SMALL)
        cfg.set_defaults("speech_translation")
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def speech_pair():
    """A small Whisper-style model and its JAX counterpart on the same
    numpy-seeded weights, and a batch of 16 utterances' log-mel features."""
    from pasero_torch.scripts.bench_decode import random_state
    jcfg, tcfg = configs()
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32)
    tmodel = Transformer(tcfg, VOCAB, dtype=torch.float32)
    tmodel.load_state_dict(random_state(tmodel, 0))
    params = traverse_util.unflatten_dict(
        checkpoints.state_dict_to_params(tmodel.state_dict()), sep="/")
    feats = [torch_log_mel(a[None])[0] for a in utterances(16)]
    T = max(len(f) for f in feats)
    src = np.zeros((16, T, 80), np.float32)
    src_mask = np.zeros((16, T), bool)
    for i, f in enumerate(feats):
        src[i, :len(f)] = f
        src_mask[i, :len(f)] = True
    return jcfg, jmodel, params, tmodel.eval(), src, src_mask


def test_speech_model_has_no_source_table(speech_pair):
    """The port's parameters are the flax model's, names and shapes: no
    source or shared token table, Conv kernels (k, in, out)."""
    _, jmodel, params, tmodel, _, _ = speech_pair
    names = set(dict(tmodel.named_parameters()))
    assert "encoder.embed_tokens.embedding" not in names
    assert "shared_embed.embedding" not in names
    assert tmodel.encoder.subsampler.conv0.weight.shape == (64, 80, 3)
    abstract = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), src_tokens=jnp.zeros((1, 4, 80)),
        decoder_input=jnp.zeros((1, 4), jnp.int32)))["params"]
    want = traverse_util.flatten_dict(nn.meta.unbox(abstract), sep="/")
    got = traverse_util.flatten_dict(params, sep="/")
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["encoder/subsampler/conv0/kernel"].shape == (3, 80, 64)


def test_encoder_and_logits_match_jax(speech_pair):
    _, jmodel, params, tmodel, src, src_mask = speech_pair
    rng = np.random.default_rng(1)
    dec = rng.integers(4, VOCAB, (16, 7)).astype(np.int32)
    dec[:, 0] = 2

    @jax.jit
    def forward(params, src, src_mask, dec):
        enc = jmodel.apply({"params": params}, src, src_mask,
                           method=JaxTransformer.encode)
        logits = jmodel.apply({"params": params}, src_tokens=src,
                              src_mask=src_mask, decoder_input=dec)["logits"]
        return enc, logits

    (enc_j, mask_j), logits_j = forward(params, jnp.asarray(src),
                                        jnp.asarray(src_mask),
                                        jnp.asarray(dec))
    with torch.no_grad():
        enc_t, mask_t = tmodel.encode(torch.from_numpy(src),
                                      torch.from_numpy(src_mask))
        logits_t = tmodel(torch.from_numpy(src), torch.from_numpy(dec),
                          src_mask=torch.from_numpy(src_mask))["logits"]
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert mask_t.shape[1] == (src.shape[1] - 1) // 2 + 1
    assert np.abs(enc_t.numpy() - np.asarray(enc_j)).max() <= 1e-4
    assert np.abs(logits_t.numpy() - np.asarray(logits_j)).max() <= 1e-4


def run_search(speech_pair, jax_search, torch_search, **opts):
    jcfg, _, params, tmodel, src, src_mask = speech_pair
    B = src.shape[0]
    prompt = np.full((B, 8), 1, np.int64)
    prompt[:, -1] = 2                    # left-aligned BOS
    prompt_mask = prompt != 1
    S = (src.shape[1] - 1) // 2 + 1
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB,
                            self_cache_len=8 + MAX_NEW, cross_cache_len=S,
                            dtype=jnp.float32)
    common = dict(max_new=MAX_NEW, eos_idx=2, pad_idx=1)

    @jax.jit
    def run(params, src, src_mask, prompt, prompt_mask):
        enc, enc_mask = jmodel.apply({"params": params}, src,
                                     src_mask=src_mask,
                                     method=JaxTransformer.encode)
        return jax_search(jmodel, params, prompt, prompt_mask,
                          encoder_out=enc, encoder_mask=enc_mask, **common,
                          **opts)

    want = run(params, jnp.asarray(src), jnp.asarray(src_mask),
               jnp.asarray(prompt, jnp.int32), jnp.asarray(prompt_mask))
    want = {k: np.asarray(v) for k, v in want.items()}
    with torch.inference_mode():
        enc, enc_mask = tmodel.encode(torch.from_numpy(src),
                                      torch.from_numpy(src_mask))
        got = torch_search(tmodel, torch.from_numpy(prompt),
                           torch.from_numpy(prompt_mask), encoder_out=enc,
                           encoder_mask=enc_mask, **common, **opts)
    return {k: v.numpy() for k, v in got.items() if k != "model_calls"}, want


def test_greedy_matches_jax(speech_pair):
    got, want = run_search(speech_pair, jax_sample_decode, sample_decode,
                           greedy=True)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= 1e-4


def test_beam5_matches_jax(speech_pair):
    got, want = run_search(speech_pair, jax_beam_search, beam_search,
                           beam_size=5)
    live = want["scores"] > NEG_INF / 2
    assert live.all()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert np.abs(got["scores"] - want["scores"]).max() <= 1e-4


def test_conv_kernels_round_trip(speech_pair):
    _, _, _, tmodel, _, _ = speech_pair
    flat = checkpoints.state_dict_to_params(tmodel.state_dict())
    np.testing.assert_array_equal(
        flat["encoder/subsampler/conv1/kernel"],
        tmodel.encoder.subsampler.conv1.weight.detach().numpy()
        .transpose(2, 1, 0))
    back = checkpoints.params_to_state_dict(flat)
    for key, value in tmodel.state_dict().items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)


# -- one Trainer update against the JAX Trainer --------------------------------

def make_cfg(cls, tmp, ckpt):
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    cfg = cls("--data-dir", os.path.join(tmp, "data"), "-o",
              os.path.join(tmp, "model"), "-s", "en", "-t", "en",
              "--allow-monolingual", "--task", "speech_translation",
              "--arch", "whisper_base", "--max-steps", "2", "--valid-interval", "2",
              "--log-interval", "1", "--seed", "0", "--dropout", "0",
              "--lr", "1e-3", "--warmup", "2", "--label-smoothing", "0.1",
              "--ckpt", ckpt)
    for k, v in SMALL.items():
        setattr(cfg.model_cfg, k, v)
    return cfg


def test_trainer_steps_match_jax(speech_pair, tmp_path):
    from pasero_torch.scripts.bench_decode import random_state
    *_, src, src_mask = speech_pair
    tmp = str(tmp_path)
    ckpt = os.path.join(tmp, "init.npz")
    cfg = make_cfg(TrainingConfig, os.path.join(tmp, "torch"), ckpt)
    model = Transformer(cfg.model_cfg, VOCAB, dtype=torch.float32)
    checkpoints.save_flat(ckpt, checkpoints.state_dict_to_params(
        random_state(model, 0)))
    rng = np.random.default_rng(2)
    batches = []
    for rows in (slice(0, 8), slice(8, 16)):
        dec = rng.integers(4, VOCAB, (8, 12)).astype(np.int32)
        dec[:, 0] = 2
        target_mask = np.ones((8, 12), bool)
        target_mask[3, 7:] = False
        dec[~target_mask] = 1
        batches.append({"src_tokens": src[rows], "src_mask": src_mask[rows],
                        "decoder_input": dec, "target_mask": target_mask,
                        "prompt_mask": np.zeros((8, 12), bool),
                        "num_real_rows": 8})
    trainer = Trainer(cfg, None, model, device="cpu")
    it = iter(batches)
    torch_logs = [trainer.train_step(it) for _ in batches]

    jcfg = make_cfg(JaxTrainingConfig, os.path.join(tmp, "jax"), ckpt)
    jcfg.prng_impl = None     # keep jax's process-wide PRNG as it is
    jmodel = JaxTransformer(jcfg.model_cfg, src_vocab_size=VOCAB,
                            dtype=jnp.float32)
    jtrainer = JaxTrainer(jcfg, task=None, model=jmodel,
                          mesh=make_mesh(1, 1, 1, devices=jax.devices()[:1]))
    it = iter(batches)
    jax_logs = [jtrainer.train_step(it) for _ in batches]
    for got, want in zip(torch_logs, jax_logs):
        for key in ("loss", "nll_loss", "gnorm"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
        assert got["num_tokens"] == want["num_tokens"]
