"""The st-mini speech anchor: the port's bfloat16 decodes and its training
CLI against the JAX package's committed outputs, on the CPU.

``pasero_torch/testdata/st-mini`` is a Whisper-style model
(``pasero_torch/testdata/st_mini.yaml``: whisper_base cut to 2 + 2 layers of
width 128) that transcribes synthesized speech, trained 1000 steps by the
JAX training CLI on the CPU (270 s of wall time on 8 CPU cores):

    for s in train valid test; do
        python pasero_torch/testdata/synth_speech.py \\
            examples/deen-mini/data/$s.en $TMP/wav_$s
        JAX_PLATFORMS=cpu python examples/speech-translation/extract_features.py \\
            $TMP/wav_$s/*.wav -o $TMP/data/$s.feats
    done
    cp examples/deen-mini/data/{bpecodes,dict.txt,train.en,valid.en} $TMP/data
    printf '<|en|> 0\\n<|transcribe|> 0\\n<|notimestamps|> 0\\n' \\
        >> $TMP/data/dict.txt
    JAX_PLATFORMS=cpu python -m cli.train --config $TMP/st_anchor.yaml

where ``st_anchor.yaml`` is st_mini.yaml with ``data_dir: $TMP/data``,
``model_dir: $TMP/model``, the corpora ``train.feats``/``train.en`` and
``valid.feats``/``valid.en``, ``batch_size: 4096``, ``warmup: 100``,
``max_steps: 1000``, ``valid_interval: 250`` and ``log_interval: 50``
(the train features were extracted in six parallel shards and concatenated
into one ``NumpyFile``; the validation nll reached 0.182). Committed: the
model (``model_best.npz`` is ``model_1000.npz``, config, dictionary,
bpecodes, inference.yaml), the wavs of the first 32 lines of test.en and a
``NumpyFile`` of their features (``test.feats``, by the same
extract_features.py), and ``test.en``'s 32 lines. JAX's greedy decode of
the wavs reproduces 25 of the 32 lines exactly.

Golden files in ``pasero_torch/testdata``, regenerated on the CPU with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_speech_anchor.py

- ``st_mini_greedy.jax.txt``: the JAX TextGenerator's greedy decode
  (bfloat16, three prompt tags) of the 32 wavs;
- ``st_mini_beam5.jax.txt``: ``python -m cli.decode st-mini -i test.feats
  --beam-size 5``;
- ``st_mini_train20.jax.json``: the JAX training CLI's 20 per-step losses on
  st_mini.yaml (the 32 utterances, batches of 1024 frames) from the weights
  of ``random_state(model, 0)``, with the flags of
  tests/test_torch_train_cli.py.

Gates: at least 30 of 32 lines equal to the golden in bfloat16 (bf16 rounds
at other places in the two frameworks), and all 20 losses within 1 %.
"""

import glob
import json
import os

from test_torch_train_cli import (ONE_THREAD, ROOT, RTOL, STEPS, run_cli,
                                  train_flags)

TESTDATA = os.path.join(ROOT, "pasero_torch", "testdata")
ST = os.path.join(TESTDATA, "st-mini")
CONFIG = os.path.join(TESTDATA, "st_mini.yaml")
WAVS = sorted(glob.glob(os.path.join(ST, "wav", "*.wav")))
FEATS = os.path.join(ST, "test.feats")
GREEDY = os.path.join(TESTDATA, "st_mini_greedy.jax.txt")
BEAM5 = os.path.join(TESTDATA, "st_mini_beam5.jax.txt")
TRAIN20 = os.path.join(TESTDATA, "st_mini_train20.jax.json")
MIN_EQUAL = 30


def read_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_anchor_files():
    assert len(WAVS) == 32
    from pasero_torch.data.files import NumpyFile
    feats = list(NumpyFile(FEATS))
    assert len(feats) == 32 and all(f.shape[1] == 80 for f in feats)


def test_generator_decodes_wavs_as_jax():
    """wav -> log-mel (the plain version on the CPU) -> greedy with the
    three prompt tags, in bfloat16."""
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.ops.mel import power_mel
    before = power_mel.launches
    gen = TextGenerator.build(ST, device="cpu")
    assert gen.task.get_target_tags(gen.task.make_meta()) == [
        "<|en|>", "<|transcribe|>", "<|notimestamps|>"]
    got = gen.decode(WAVS)
    want = read_lines(GREEDY)
    assert sum(a == b for a, b in zip(got, want)) >= MIN_EQUAL, \
        list(zip(got, want))
    assert power_mel.launches == before


def test_cli_decodes_features_as_jax(tmp_path):
    """``cli.decode`` beam-5 on the binary feature file, through
    InferenceSpeechCorpus."""
    from pasero_torch.cli.decode import main
    out = tmp_path / "out.txt"
    main([ST, "-i", FEATS, "-o", str(out), "--beam-size", "5",
          "--device", "cpu"])
    got, want = read_lines(out), read_lines(BEAM5)
    assert len(got) == 32
    assert sum(a == b for a, b in zip(got, want)) >= MIN_EQUAL, \
        list(zip(got, want))


def test_training_cli_matches_jax_losses(tmp_path):
    with open(TRAIN20) as f:
        golden = json.load(f)["steps"]
    logs, model_dir, out = run_cli("pasero_torch.cli.train", str(tmp_path),
                                   ["--device", "cpu"], env=ONE_THREAD,
                                   config=CONFIG)
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1))
    for got, want in zip(logs, golden):
        for key in ("loss", "nll_loss"):
            assert abs(got[key] - want[key]) <= RTOL * abs(want[key]), \
                (got, want)
        assert got["lr"] == want["lr"], (got, want)
    assert "valid | test.feats.en-en | valid_loss" in out
    assert os.path.exists(os.path.join(model_dir, "model_20.npz"))


def regenerate():
    """Run the JAX package on the CPU and write the three golden files."""
    import subprocess
    import sys
    import tempfile
    from pasero_tpu.decoding.generator import TextGenerator
    with open(GREEDY, "w") as f:
        f.write("\n".join(TextGenerator.build(ST).decode(WAVS)) + "\n")
    subprocess.run([sys.executable, "-m", "cli.decode", ST, "-i", FEATS,
                    "-o", BEAM5, "--beam-size", "5"], cwd=ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": ROOT,
                        "JAX_PLATFORMS": "cpu"})
    with tempfile.TemporaryDirectory() as tmp:
        logs, _, _ = run_cli("cli.train", tmp, env={"JAX_PLATFORMS": "cpu"},
                             config=CONFIG)
    assert [s["step"] for s in logs] == list(range(1, STEPS + 1)), logs
    flags = train_flags("<model_dir>", "<init.npz>", CONFIG)
    with open(TRAIN20, "w") as f:
        json.dump({"command": "python -m cli.train (pasero_tpu) on the CPU",
                   "initial_weights": "random_state(model, seed 0) of "
                                      "pasero_torch.scripts.bench_decode",
                   "flags": [os.path.relpath(a, ROOT)
                             if a.startswith(ROOT) else a for a in flags],
                   "steps": logs}, f, indent=1)
    print(f"wrote {GREEDY}, {BEAM5} and {TRAIN20}")


if __name__ == "__main__":
    regenerate()


def test_whisper_model_directory_decodes(tmp_path):
    """The whisper_base directory of bench_decode and chip_smoke (seeded
    weights, Whisper's 51865 entries), cut to one layer a side, through
    ``TextGenerator.decode`` of two wav files: features bucketed at their
    100 frames, the three prompt tags, up to 4 new tokens each."""
    from pasero_torch.ops.mel import power_mel
    from pasero_torch.scripts.bench_decode import WhisperWorkload
    before = power_mel.launches
    work = WhisperWorkload(batch=2, seconds=1.0, max_new=4, device="cpu",
                           model_dir=str(tmp_path / "whisper"), layers=1)
    gen = work.generator
    assert gen.task.decoder_num_embeddings == WhisperWorkload.VOCAB
    assert work.prompt == ["<|en|>", "<|transcribe|>", "<|notimestamps|>"]
    assert (work.cfg.embed_dim, work.cfg.encoder_layers) == (512, 1)
    out = work.run()
    assert len(out["hyps"]) == 2
    assert all(1 <= len(h[0]["tokens"]) <= 4 for h in out["hyps"])
    # the prompt call, then one call per new token
    assert 2 <= out["model_calls"] <= 5
    assert power_mel.launches == before
