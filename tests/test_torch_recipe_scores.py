"""The recipe-score reader and its two-sample comparison, on synthetic logs
in the training CLIs' format."""

import json

import pytest

from pasero_torch.scripts.recipe_scores import compare, main, scores


def write_log(path, bleus):
    lines = []
    for step, bleu in zip((1000, 2000, 3000), bleus):
        lines.append(f"2026-01-01 | train | step {step} | loss 1.0 | lr 1e-4")
        lines.append(f"2026-01-01 | train | valid | valid.de-en | valid_loss 1.1 "
                     f"| bleu 99.0 | chrf 99.5 | eval_time 1.0")
        lines.append(f"2026-01-01 | train | valid | test_hard.de-en | valid_loss "
                     f"5.7 | bleu {bleu} | chrf 23.1 | eval_time 2.0")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_scores_of_the_last_step(tmp_path):
    log = write_log(tmp_path / "a.log", [3.5, 4.25, 5.5])
    assert scores(log, "test_hard.de-en", "bleu") == 5.5
    assert scores(log, "valid.de-en", "chrf") == 99.5
    with pytest.raises(ValueError):
        scores(log, "test.de-en", "bleu")


def test_compare_permutation_p():
    """Identical groups: p = 1; groups that do not overlap: only the two
    extreme splits of 70 reach the observed difference."""
    same = compare([1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0])
    assert same["permutation_p"] == 1.0 and same["difference"] == 0.0
    apart = compare([1.0, 1.1, 1.2, 1.3], [5.0, 5.1, 5.2, 5.3])
    assert apart["splits"] == 70
    assert apart["permutation_p"] == pytest.approx(2 / 70)
    assert apart["welch_t"] < -30


def test_main_prints_both_groups(tmp_path, capsys):
    a = [write_log(tmp_path / f"a{i}.log", [1, 2, b]) for i, b in
         enumerate((5.0, 6.0))]
    b = [write_log(tmp_path / f"b{i}.log", [1, 2, b]) for i, b in
         enumerate((7.0, 8.0))]
    main(["--corpus", "test_hard.de-en", "--metric", "bleu", "--a", *a,
          "--b", *b])
    out = json.loads(capsys.readouterr().out)
    assert out["a"] == [5.0, 6.0] and out["b"] == [7.0, 8.0]
    assert out["difference"] == -2.0 and out["splits"] == 6
