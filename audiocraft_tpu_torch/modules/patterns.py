"""Codebook interleaving patterns (counterpart of
`audiocraft_tpu/modules/patterns.py`: `Pattern`, `CodebooksPatternProvider`,
`DelayedPatternProvider`, `ParallelPatternProvider`,
`UnrolledPatternProvider`, `CoarseFirstPattern`, `MusicLMPattern`).

The layout and the index tables are host-side numpy, computed once per
(timesteps, n_q); building or reverting a sequence is one gather on the
tensor's own device.
"""
import typing as tp
from collections import namedtuple
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

LayoutCoord = namedtuple("LayoutCoord", ["t", "q"])  # (timestep, codebook)
PatternLayout = tp.List[tp.List[LayoutCoord]]


def _gather_last(x: torch.Tensor, indexes: np.ndarray, fill) -> torch.Tensor:
    """x [..., K, N] -> [..., K', T'] picking flat positions `indexes` [K', T']
    of x's last two axes; position K*N (one past the end) reads `fill`."""
    *lead, K, N = x.shape
    flat = x.reshape(*lead, K * N)
    pad = torch.full((*lead, 1), fill, dtype=x.dtype, device=x.device)
    flat = torch.cat([flat, pad], dim=-1)
    idx = torch.from_numpy(indexes.reshape(-1).astype(np.int64)).to(x.device)
    return flat.index_select(-1, idx).reshape(*lead, *indexes.shape)


@dataclass
class Pattern:
    """Interleaving pattern: ``layout[s]`` lists the (t, q) coords at
    sequence step ``s``; the first entry is usually empty so a special token
    starts the sequence."""
    layout: PatternLayout
    timesteps: int
    n_q: int

    def __post_init__(self):
        assert len(self.layout) > 0
        self._validate_layout()
        self._build_pattern_index_cache: dict = {}
        self._build_revert_index_cache: dict = {}

    def _validate_layout(self):
        q_timesteps = {q: 0 for q in range(self.n_q)}
        for s, seq_coords in enumerate(self.layout):
            qs = set()
            for coord in seq_coords:
                qs.add(coord.q)
                assert coord.t >= q_timesteps[coord.q], \
                    f"Past timesteps are found in the sequence for codebook = {coord.q} at step {s}"
                q_timesteps[coord.q] = coord.t
            assert len(qs) == len(seq_coords), \
                f"Multiple entries for a same codebook are found at step {s}"

    @property
    def num_sequence_steps(self) -> int:
        return len(self.layout) - 1

    @property
    def max_delay(self) -> int:
        max_t_in_seq_coords = 0
        for seq_coords in self.layout[1:]:
            for coords in seq_coords:
                max_t_in_seq_coords = max(max_t_in_seq_coords, coords.t + 1)
        return max_t_in_seq_coords - self.timesteps

    @property
    def valid_layout(self) -> PatternLayout:
        valid_step = len(self.layout) - self.max_delay
        return self.layout[:valid_step]

    def starts_with_special_token(self) -> bool:
        return self.layout[0] == []

    def get_sequence_coords_with_timestep(self, t: int,
                                          q: tp.Optional[int] = None):
        assert t <= self.timesteps
        coords = []
        for s, seq_codes in enumerate(self.layout):
            for code in seq_codes:
                if code.t == t and (q is None or code.q == q):
                    coords.append((s, code))
        return coords

    def get_steps_with_timestep(self, t: int, q: tp.Optional[int] = None
                                ) -> tp.List[int]:
        return [step for step, _ in self.get_sequence_coords_with_timestep(t, q)]

    def get_first_step_with_timesteps(self, t: int, q: tp.Optional[int] = None
                                      ) -> tp.Optional[int]:
        steps = self.get_steps_with_timestep(t, q)
        return steps[0] if steps else None

    def _build_pattern_sequence_scatter_indexes(self, timesteps: int, n_q: int,
                                                keep_only_valid_steps: bool):
        """Indexes [K, S] into the flattened [K*T + 1] input; mask [K, S]."""
        key = (timesteps, n_q, keep_only_valid_steps)
        if key in self._build_pattern_index_cache:
            return self._build_pattern_index_cache[key]
        assert n_q == self.n_q
        assert timesteps <= self.timesteps, \
            "invalid number of timesteps used to build the sequence from the pattern"
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        indexes = np.full((n_q, len(ref_layout)), n_q * timesteps, dtype=np.int32)
        mask = np.zeros((n_q, len(ref_layout)), dtype=bool)
        for s, sequence_coords in enumerate(ref_layout):
            for coords in sequence_coords:
                if coords.t < timesteps:
                    indexes[coords.q, s] = coords.t + coords.q * timesteps
                    mask[coords.q, s] = True
        self._build_pattern_index_cache[key] = (indexes, mask)
        return indexes, mask

    def build_pattern_sequence(self, z: torch.Tensor, special_token: int,
                               keep_only_valid_steps: bool = False):
        """Codes [B, K, T] -> interleaved [B, K, S], indexes, mask."""
        B, K, T = z.shape
        indexes, mask = self._build_pattern_sequence_scatter_indexes(
            T, K, keep_only_valid_steps)
        return _gather_last(z, indexes, special_token), indexes, mask

    def _build_reverted_sequence_scatter_indexes(
            self, sequence_steps: int, n_q: int,
            keep_only_valid_steps: bool = False, is_model_output: bool = False):
        """Indexes [K, T] into the flattened [K*S + 1] sequence; mask [K, T]."""
        key = (sequence_steps, n_q, keep_only_valid_steps, is_model_output)
        if key in self._build_revert_index_cache:
            return self._build_revert_index_cache[key]
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        timesteps = self.timesteps
        assert n_q == self.n_q
        assert sequence_steps <= len(ref_layout), \
            f"sequence to revert is longer than the defined pattern: {sequence_steps} > {len(ref_layout)}"
        if is_model_output and self.starts_with_special_token():
            ref_layout = ref_layout[1:]
        indexes = np.full((n_q, timesteps), n_q * sequence_steps, dtype=np.int32)
        mask = np.zeros((n_q, timesteps), dtype=bool)
        for s, sequence_codes in enumerate(ref_layout):
            if s < sequence_steps:
                for code in sequence_codes:
                    if code.t < timesteps:
                        indexes[code.q, code.t] = s + code.q * sequence_steps
                        mask[code.q, code.t] = True
        self._build_revert_index_cache[key] = (indexes, mask)
        return indexes, mask

    def revert_pattern_sequence(self, s: torch.Tensor, special_token: int,
                                keep_only_valid_steps: bool = False):
        """Interleaved [B, K, S] -> codes [B, K, T], indexes, mask."""
        B, K, S = s.shape
        indexes, mask = self._build_reverted_sequence_scatter_indexes(
            S, K, keep_only_valid_steps, is_model_output=False)
        return _gather_last(s, indexes, special_token), indexes, mask

    def revert_pattern_logits(self, logits: torch.Tensor, special_token: float,
                              keep_only_valid_steps: bool = False):
        """Logits [B, card, K, S] -> [B, card, K, T], skipping the initial
        special-token step so logits align with their targets."""
        B, card, K, S = logits.shape
        indexes, mask = self._build_reverted_sequence_scatter_indexes(
            S, K, keep_only_valid_steps, is_model_output=True)
        return _gather_last(logits, indexes, special_token), indexes, mask


class CodebooksPatternProvider:
    """Pattern factory: `get_pattern(timesteps)`, memoised per instance."""

    def __init__(self, n_q: int):
        assert n_q > 0
        self.n_q = n_q
        self.get_pattern = lru_cache(100)(self.get_pattern)  # type: ignore

    def get_pattern(self, timesteps: int) -> Pattern:
        raise NotImplementedError()


class DelayedPatternProvider(CodebooksPatternProvider):
    """MusicGen delay pattern: codebook q is delayed by delays[q] steps
    (default q)."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None,
                 flatten_first: int = 0, empty_initial: int = 0):
        super().__init__(n_q)
        if delays is None:
            delays = list(range(n_q))
        self.delays = delays
        self.flatten_first = flatten_first
        self.empty_initial = empty_initial
        assert len(self.delays) == self.n_q
        assert sorted(self.delays) == self.delays

    def get_pattern(self, timesteps: int) -> Pattern:
        omit_special_token = self.empty_initial < 0
        out: PatternLayout = [] if omit_special_token else [[]]
        max_delay = max(self.delays)
        if self.empty_initial:
            out += [[] for _ in range(self.empty_initial)]
        if self.flatten_first:
            for t in range(min(timesteps, self.flatten_first)):
                for q in range(self.n_q):
                    out.append([LayoutCoord(t, q)])
        for t in range(self.flatten_first, timesteps + max_delay):
            v = []
            for q, delay in enumerate(self.delays):
                t_for_q = t - delay
                if t_for_q >= self.flatten_first:
                    v.append(LayoutCoord(t_for_q, q))
            out.append(v)
        return Pattern(out, n_q=self.n_q, timesteps=timesteps)


class ParallelPatternProvider(DelayedPatternProvider):
    """Every codebook at the same step (no delays)."""

    def __init__(self, n_q: int, empty_initial: int = 0):
        super().__init__(n_q, [0] * n_q, empty_initial=empty_initial)


class UnrolledPatternProvider(CodebooksPatternProvider):
    """Codebooks flattened into inner steps: `flattening[q]` is the inner
    step of codebook q (codebooks that share one are predicted together)
    and `delays[q]` shifts that inner step by whole timesteps. Each timestep
    spans as many sequence steps as there are inner steps."""

    def __init__(self, n_q: int, flattening: tp.Optional[tp.List[int]] = None,
                 delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        flattening = list(range(n_q)) if flattening is None else flattening
        delays = [0] * n_q if delays is None else delays
        assert len(flattening) == n_q and len(delays) == n_q
        assert sorted(flattening) == flattening and sorted(delays) == delays
        # inner step -> (its codebooks, their common delay)
        self._inner: tp.Dict[int, tp.Tuple[tp.List[int], int]] = {}
        for q, (inner, delay) in enumerate(zip(flattening, delays)):
            codebooks, known = self._inner.setdefault(inner, ([], delay))
            assert known == delay, ("codebooks flattened to one inner step "
                                    "must share their delay")
            codebooks.append(q)
        self.max_delay = max(delays)

    def get_pattern(self, timesteps: int) -> Pattern:
        n_inner = max(self._inner) + 1
        horizon = timesteps + self.max_delay
        # (sort key, coords): an inner step of timestep t sits at t + delay;
        # equal keys order by their coordinates, empty steps first; a
        # missing inner step leaves an empty sequence step
        steps: tp.List[tp.Tuple[int, tp.List[LayoutCoord]]] = [(-1, [])]
        for t in range(horizon):
            for inner in range(n_inner):
                if inner not in self._inner:
                    steps.append((t, []))
                    continue
                codebooks, delay = self._inner[inner]
                if t + delay < horizon:
                    steps.append((t + delay,
                                  [LayoutCoord(t, q) for q in codebooks]))
        layout = [coords for _, coords in sorted(steps)]
        return Pattern(layout, n_q=self.n_q, timesteps=timesteps)


class CoarseFirstPattern(CodebooksPatternProvider):
    """Codebook 0 over every timestep first, then codebooks 1.. together,
    codebook q + 1 delayed by `delays[q]`. The fine codebooks see all of the
    coarse one, so generate the whole duration at once."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        self.delays = [0] * (n_q - 1) if delays is None else delays
        assert len(self.delays) == n_q - 1
        assert sorted(self.delays) == self.delays

    def get_pattern(self, timesteps: int) -> Pattern:
        layout: PatternLayout = [[]]
        layout += [[LayoutCoord(t, 0)] for t in range(timesteps)]
        for t in range(timesteps + max(self.delays)):
            layout.append([LayoutCoord(t - delay, q + 1)
                           for q, delay in enumerate(self.delays)
                           if t - delay >= 0])
        return Pattern(layout, n_q=self.n_q, timesteps=timesteps)


class MusicLMPattern(CodebooksPatternProvider):
    """Groups of `group_by` codebooks, one group after the other; inside a
    group every timestep lists its codebooks one per sequence step."""

    def __init__(self, n_q: int, group_by: int = 2):
        super().__init__(n_q)
        self.group_by = group_by

    def get_pattern(self, timesteps: int) -> Pattern:
        layout: PatternLayout = [[]]
        for first in range(0, self.n_q, self.group_by):
            for t in range(timesteps):
                layout += [[LayoutCoord(t, q)]
                           for q in range(first, first + self.group_by)]
        return Pattern(layout, n_q=self.n_q, timesteps=timesteps)
