"""The one traffic generator: every mix is a JSON file of parameters under
`portbench/traffic/`, read here.

Text-to-music mixes ("kind": "text_to_music") give each request
`texts_per_request` prompts. A prompt's word count comes from the cycle
`word_counts`, shuffled by the seed each time it is used up, so every seed
sends the same counts in another order; its words are drawn from
`vocabulary` by the seed and the request's number. Every `greedy_every`-th
request decodes greedily and the rest sample with `top_k`: the check holds
a greedy token against the reference's best and a sampled one against the
reference's top k. The warm-up sends one request of each kind. Training mixes ("kind": "lm_training") give one batch of
`batch` rows of `seconds` each: uniform random codes drawn on the device
from the seed, and one prompt per row as above.
"""
import dataclasses
import typing as tp

import numpy as np


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *keys])


def _word_count_stream(counts: tp.Sequence[int], seed: int, n: int
                       ) -> tp.List[int]:
    """The first `n` word counts: the cycle, shuffled anew per pass."""
    out: tp.List[int] = []
    rng = _rng(seed, 1)
    while len(out) < n:
        out.extend(int(c) for c in rng.permutation(list(counts)))
    return out[:n]


def _prompt(vocab: tp.Sequence[str], words: int, rng) -> str:
    return " ".join(vocab[j] for j in rng.integers(0, len(vocab), words))


@dataclasses.dataclass(frozen=True)
class Request:
    texts: tp.List[str]
    greedy: bool


class TextToMusic:
    """Requests of a text-to-music mix; request i < 0 is a warm-up."""

    WARMUP = (-2, -1)  # one sampled, one greedy

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = int(seed)

    @property
    def texts_per_request(self) -> int:
        return int(self.p["texts_per_request"])

    def greedy(self, i: int) -> bool:
        if i < 0:
            return i == -1
        every = int(self.p["greedy_every"])
        return i % every == every - 1

    def request(self, i: int) -> Request:
        n = self.texts_per_request
        # warm-ups read their own stretch of the count stream, after the
        # first 4096 requests' worth
        slot = i if i >= 0 else 4096 - i
        counts = _word_count_stream(self.p["word_counts"], self.seed,
                                    (slot + 1) * n)[slot * n:]
        rng = _rng(self.seed, 2, slot)
        return Request([_prompt(self.p["vocabulary"], c, rng) for c in counts],
                       self.greedy(i))

    def rows_to_check(self, i: int) -> tp.List[int]:
        """The rows of request i that the check reads, drawn from the
        seed."""
        n = min(int(self.p["rows_checked"]), self.texts_per_request)
        rng = _rng(self.seed, 3, max(i, 0))
        return sorted(int(r) for r in rng.choice(self.texts_per_request, n,
                                                 replace=False))

    def requests_to_check(self, done: tp.Sequence[int]) -> tp.List[int]:
        """A sample, drawn from the seed, of the requests done: up to
        `requests_checked` greedy ones and `sampled_checked` sampled
        ones."""
        out: tp.List[int] = []
        for key, greedy, n in ((4, True, self.p["requests_checked"]),
                               (5, False, self.p["sampled_checked"])):
            pool = [int(i) for i in done if self.greedy(int(i)) == greedy]
            rng = _rng(self.seed, key)
            out += [pool[j] for j in rng.choice(len(pool), min(int(n), len(pool)),
                                                replace=False)]
        return sorted(out)


class LMTraining:
    """One training batch."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = int(seed)

    @property
    def batch(self) -> int:
        return int(self.p["batch"])

    def texts(self) -> tp.List[str]:
        counts = _word_count_stream(self.p["word_counts"], self.seed,
                                    self.batch)
        rng = _rng(self.seed, 2)
        return [_prompt(self.p["vocabulary"], c, rng) for c in counts]

    def codes(self, torch, n_q: int, card: int, frames: int, device):
        """[batch, n_q, frames] uniform codes, drawn on `device`."""
        g = torch.Generator(device).manual_seed(int(self.seed) % (2 ** 63))
        return torch.randint(0, card, (self.batch, n_q, frames),
                             generator=g, device=device)


KINDS = {"text_to_music": TextToMusic, "lm_training": LMTraining}


def make(params: dict, seed: int):
    return KINDS[params["kind"]](params, seed)
