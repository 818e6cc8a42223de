"""How ``correct`` is decided for a served model.

After the window, a sample of the requests it finished, drawn from the
seed and always holding the one with the most served tokens, is run
through the plain reference once: each prompt followed by its served
tokens but the last, one forward pass, logits at every position that
gave a served token.  Each served token's gap is how far its logit lies
below the reference's best at its position (0 where the program chose
the reference's own top token: greedy decoding claims no more).  Two
numbers are compared, each with its limit (``NUMBERS``): the mean gap
over every compared token, and the worst request's mean gap, so that a
fault confined to one slot or one request is not diluted by the rest.
The widest gap is printed beside them and not compared: under SINT a
last-bit difference moves an activation code a whole step, so a few
tokens of a sound run lie far down and the widest does not part sound
runs from the control (PERF.md, Findings).

The control (``perfbench/control.py``) reads the gap of the token that
the reference computed one precision lower puts first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Served:
    prompt: np.ndarray
    tokens: np.ndarray


NUMBERS = ("mean_gap", "worst_request_gap")


def numbers(per_request: Sequence[Sequence[float]]
            ) -> Dict[str, Optional[float]]:
    """The numbers compared, from each request's gaps: the mean over every
    token, and the largest of the requests' own means."""
    flat = [g for r in per_request for g in r]
    if not flat:
        return dict.fromkeys(NUMBERS)
    return {"mean_gap": sum(flat) / len(flat),
            "worst_request_gap": max(sum(r) / len(r)
                                     for r in per_request if r)}


def sample(done: Sequence[Served], n: int, seed: int) -> List[Served]:
    """``n`` of the finished requests, drawn from ``seed``, the one with
    the most served tokens (then the longest prompt) always among them."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens),
                                                   len(done[i].prompt)))
    rng = np.random.default_rng([seed, 1])
    rest = [i for i in range(len(done)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def _by_row(gaps: torch.Tensor, rows: List[int], n: int
            ) -> List[List[float]]:
    out: List[List[float]] = [[] for _ in range(n)]
    for r, g in zip(rows, gaps.tolist()):
        out[r].append(g)
    return out


def _blocks(items: Sequence[Served], block: int):
    for at in range(0, len(items), block):
        yield items[at:at + block]


def gaps(hidden: Callable, logits_at: Callable, items: Sequence[Served],
         block: int, device: torch.device,
         control: Optional[Tuple[Callable, Callable]] = None
         ) -> Tuple[List[List[float]], List[List[float]]]:
    """Per request, per served token, the gap of the served token under
    the reference
    (``hidden(tokens) -> (B, T, D)``, ``logits_at(x, rows, cols) -> (n,
    V)``), and with ``control`` (its own two functions) the gap of the
    control's first token under the same reference logits.  Rows are
    right-padded to the block's longest; causal models never read the
    padding at the positions compared."""
    served_gaps, control_gaps = [], []
    for blk in _blocks(list(items), block):
        seqs = [np.concatenate([s.prompt, s.tokens[:-1]]) for s in blk]
        width = max(len(q) for q in seqs)
        toks = np.zeros((len(seqs), width), np.int64)
        rows, cols, want = [], [], []
        for i, (q, s) in enumerate(zip(seqs, blk)):
            toks[i, :len(q)] = q
            first = len(s.prompt) - 1
            for j, tok in enumerate(s.tokens):
                rows.append(i)
                cols.append(first + j)
                want.append(int(tok))
        toks_t = torch.from_numpy(toks).to(device)
        rows_t = torch.tensor(rows, device=device)
        cols_t = torch.tensor(cols, device=device)
        want_t = torch.tensor(want, device=device)
        with torch.no_grad():
            ref = logits_at(hidden(toks_t), rows_t, cols_t)
            best = ref.max(dim=-1).values
            served_gaps += _by_row(best - ref.gather(1, want_t[:, None])
                                   [:, 0], rows, len(blk))
            if control is not None:
                c_hidden, c_logits = control
                top = c_logits(c_hidden(toks_t), rows_t, cols_t).argmax(-1)
                control_gaps += _by_row(best - ref.gather(1, top[:, None])
                                        [:, 0], rows, len(blk))
        del ref
    return served_gaps, control_gaps
