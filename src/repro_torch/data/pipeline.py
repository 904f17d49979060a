"""Deterministic, shardable, restartable synthetic token pipeline.

Port of ``repro.data.pipeline``. Every sequence is a pure function of
(seed, step, global_row): a counter-based generator (Philox) keyed by
those three numbers draws it, so a restart resumes bit-identically from the
checkpointed step with no pipeline state to save, and any host can make
exactly its shard of the global batch (``host_batch``) — re-sharding
never changes the data, because the generator is keyed per *global
row*, not per host. The distribution is the reference's: a zipf-ish
unigram (logits -1.2 log rank) with Markov runs (each token repeats the
previous one with probability ``repeat_p``), so cross-entropy falls
measurably in a short run. The tokens differ from the reference's,
whose bits come from ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    repeat_p: float = 0.7          # Markov self-transition probability

    @functools.cached_property
    def _cdf(self) -> np.ndarray:
        """The unigram's cumulative distribution (logits -1.2 log rank),
        f64, ending at 1."""
        w = np.power(np.arange(1, self.vocab_size + 1, dtype=np.float64),
                     -1.2)
        cdf = np.cumsum(w)
        return cdf / cdf[-1]

    def _row(self, step: int, row: int) -> np.ndarray:
        """One (seq_len + 1,) int32 sequence with learnable structure."""
        rng = np.random.Generator(np.random.Philox(
            np.random.SeedSequence([self.seed, step, row])))
        n = self.seq_len + 1
        base = np.minimum(np.searchsorted(self._cdf, rng.random(n),
                                          side="right"),
                          self.vocab_size - 1)
        rep = rng.random(n) < self.repeat_p
        rep[0] = False
        # a repeat keeps the last fresh draw: index of the newest non-repeat
        src = np.maximum.accumulate(np.where(rep, 0, np.arange(n)))
        return base[src].astype(np.int32)

    def _rows(self, step: int, rows) -> dict[str, torch.Tensor]:
        toks = torch.from_numpy(np.stack([self._row(step, int(r))
                                          for r in rows]))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """Full global batch for ``step`` (host tensors)."""
        return self._rows(step, range(self.global_batch))

    def host_batch(self, step: int, shard: int,
                   num_shards: int) -> dict[str, torch.Tensor]:
        """This host's contiguous row slice — identical to slicing
        ``batch(step)``, for any shard count."""
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        return self._rows(step, range(shard * per, (shard + 1) * per))


def make_stream(cfg, seq_len: int, global_batch: int,
                seed: int = 0) -> TokenStream:
    """Stream matching a model config and a (seq_len, global_batch)
    shape."""
    return TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=seed)
