"""Speaker evaluation: corpus BLEU-4 against ground-truth instructions.

A copy of ``avlen_tpu/dialog/speaker/eval_speaker.py`` (numpy only), kept in
the port so that it imports nothing of the JAX package. Counterpart of the
reference's speaker eval (ss_baselines/savi/dialog/speaker/tasks/R2R/
eval_speaker.py: decodes val paths and scores BLEU against the human R2R
instructions). Here the ground truth channel is the template speaker (the
synthetic world's oracle language), and corpus BLEU is the standard
published formula: modified n-gram precision summed over the corpus,
geometric mean over n=1..4, brevity penalty.

Scores from this harness on synthetic worlds are therefore
SELF-REFERENTIAL: they measure how well the seq2seq learned the template
channel, not R2R-grade language quality. On real data the same harness
scores against the dataset's human instructions.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence

import numpy as np


def _ngrams(tokens: Sequence[str], n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    candidates: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
    smooth: bool = False,
) -> float:
    """Corpus-level BLEU-max_n. ``references[i]`` is the list of reference
    token sequences for candidate i. ``smooth`` adds 1 to numerator and
    denominator of higher-order precisions with zero matches (method-1
    style) — off by default to match plain BLEU."""
    if len(candidates) != len(references):
        raise ValueError("candidates and references length mismatch")
    match = np.zeros(max_n)
    total = np.zeros(max_n)
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand = list(cand)
        cand_len += len(cand)
        # closest reference length (ties → shorter), standard BP convention
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(cand, n)
            max_ref = collections.Counter()
            for r in refs:
                for g, c in _ngrams(list(r), n).items():
                    max_ref[g] = max(max_ref[g], c)
            match[n - 1] += sum(min(c, max_ref[g]) for g, c in cn.items())
            # per-sentence denominator clamped to >=1 (nltk/moses convention:
            # a sentence shorter than n still contributes 1 to the total)
            total[n - 1] += max(sum(cn.values()), 1)
    log_p = 0.0
    for n in range(max_n):
        m, t = match[n], total[n]
        if t == 0:
            return 0.0
        if m == 0:
            if not smooth:
                return 0.0
            m, t = m + 1.0, t + 1.0
        log_p += math.log(m / t) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
    return bp * math.exp(log_p)


def evaluate_speaker(
    speaker,
    items: List[Dict],
    reference_words: List[List[List[str]]],
    max_n: int = 4,
) -> Dict[str, float]:
    """Decode ``items`` ({'heading','scene','path','category'} dicts, the
    generate_instr batch shape) with ``speaker`` and score against
    ``reference_words``. Returns {'bleu', 'avg_len', 'num'}."""
    outs = speaker.generate_instr(items)
    cands = [o["words"] for o in outs]
    return {
        "bleu": corpus_bleu(cands, reference_words, max_n=max_n),
        "avg_len": float(np.mean([len(c) for c in cands])) if cands else 0.0,
        "num": float(len(cands)),
    }


def evaluate_neural_vs_template(
    neural_speaker,
    template_speaker,
    scene_tables,
    num_paths: int = 64,
    max_hops: int = 8,
    seed: int = 0,
) -> Dict[str, float]:
    """BLEU of the neural speaker against the template ground truth on
    random shortest paths — the synthetic-world analogue of scoring the R2R
    speaker on the val split."""
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(num_paths):
        s = rng.randint(len(scene_tables))
        t = scene_tables[s]
        start = rng.randint(t.num_nodes)
        goals = np.where(
            (t.hops[start] >= 1) & (t.hops[start] <= max_hops)
        )[0]
        if len(goals) == 0:
            continue
        goal = int(goals[rng.randint(len(goals))])
        path = [start]
        node = start
        while node != goal:
            node = int(t.oracle_next[node, goal])
            path.append(node)
        items.append({
            "heading": int(rng.choice([0, 90, 180, 270])),
            "scene": s,
            "path": path,
            "category": int(rng.randint(21)),
        })
    refs = [[o["words"]] for o in template_speaker.generate_instr(items)]
    return evaluate_speaker(neural_speaker, items, refs)
