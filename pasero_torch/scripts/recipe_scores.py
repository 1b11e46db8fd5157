"""Scores of recipe runs from their training logs, and whether two groups of
runs differ.

    python -m pasero_torch.scripts.recipe_scores --corpus test_hard.de-en \\
        --metric bleu --a A1.log A2.log ... [--b B1.log ...]

Both training CLIs (``cli/train.py`` and ``pasero_torch.cli.train``) log a
validation as ``valid | <corpus> | ... | <metric> <value> | ...`` after the
``step N`` line of its step. Prints one JSON object: each group's scores at
the last validated step, their mean and sample standard deviation, the
difference of the means, Welch's t, and the two-sided p-value of an exact
permutation test of the difference of the means (every split of the pooled
runs into groups of the two sizes).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import re

STEP = re.compile(r"\| step (\d+) \|")
VALID = re.compile(r"\| valid \| (\S+) \|(.*)$")


def scores(path: str, corpus: str, metric: str) -> float:
    """The run's ``metric`` on ``corpus`` at its last validated step."""
    found, current = {}, 0
    with open(path, errors="replace") as f:
        for line in f:
            m = STEP.search(line)
            if m:
                current = int(m.group(1))
                continue
            m = VALID.search(line)
            if m and m.group(1) == corpus:
                parts = [p.strip() for p in m.group(2).split("|")]
                fields = dict(p.rsplit(" ", 1) for p in parts if " " in p)
                if metric in fields:
                    found[current] = float(fields[metric])
    if not found:
        raise ValueError(f"{path}: no {metric} on {corpus}")
    return found[max(found)]


def mean_sd(xs):
    mean = sum(xs) / len(xs)
    if len(xs) < 2:
        return mean, 0.0
    return mean, math.sqrt(sum((x - mean) ** 2 for x in xs) / (len(xs) - 1))


def compare(a: list, b: list) -> dict:
    """Difference of means, Welch's t and the exact two-sided permutation
    p-value of the difference of means."""
    (ma, sa), (mb, sb) = mean_sd(a), mean_sd(b)
    se = math.sqrt(sa ** 2 / len(a) + sb ** 2 / len(b))
    pooled, total = a + b, sum(a) + sum(b)
    observed = abs(ma - mb)
    hits = count = 0
    for idx in itertools.combinations(range(len(pooled)), len(a)):
        sum_a = sum(pooled[i] for i in idx)
        diff = abs(sum_a / len(a) - (total - sum_a) / len(b))
        hits += diff >= observed - 1e-12
        count += 1
    return {"mean_a": ma, "sd_a": sa, "mean_b": mb, "sd_b": sb,
            "difference": ma - mb, "welch_t": (ma - mb) / se if se else math.inf,
            "permutation_p": hits / count, "splits": count}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--metric", required=True)
    parser.add_argument("--a", nargs="+", required=True, help="group A's logs")
    parser.add_argument("--b", nargs="*", default=[], help="group B's logs")
    args = parser.parse_args(argv)
    a, b = ([scores(p, args.corpus, args.metric) for p in g]
            for g in (args.a, args.b))
    result = {"corpus": args.corpus, "metric": args.metric, "a": a, "b": b}
    if b:
        result.update(compare(a, b))
    else:
        result["mean_a"], result["sd_a"] = mean_sd(a)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
