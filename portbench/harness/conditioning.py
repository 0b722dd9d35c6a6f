"""The T5 conditioner held to its whitespace hash, and checked to use it.

`T5Conditioner` asks `transformers` for a local sentencepiece vocabulary
and falls back to its whitespace hash when it gets none. `transformers`
5.x answers a request without a vocabulary on disk with a T5 tokenizer
that maps every word to <unk>, and the conditioner takes it, so on a
machine that has `transformers` every prompt would condition alike. Until
the program refuses such a tokenizer, each T5 conditioner of the model
under test is given the answer of a machine without a vocabulary (its
`_get_tokenizer` returns None, as it does when none can be had), and
nothing else changes: `transformers` stays importable for every other
module. Set-up then checks that a known prompt tokenizes to the
reference's hash ids, so that a run whose conditioner takes any other path
fails there, loudly, and prints no result.
"""
import numpy as np

from reference import musicgen as ref

PROBE = "Calm lofi piano, warm tape hiss!"


def hold_to_hash(lm, vocab_size: int) -> None:
    """Give every T5 conditioner of `lm` the hash fallback and check it."""
    from audiocraft_tpu_torch.modules.conditioners import T5Conditioner
    conditioners = [c for c in lm.condition_provider.conditioners.values()
                    if isinstance(c, T5Conditioner)]
    if not conditioners:
        raise RuntimeError("the model has no T5 conditioner to check")
    want_ids, want_mask = ref.hash_tokens([PROBE], vocab_size)
    for c in conditioners:
        c._get_tokenizer = lambda: None
        ids, mask = c.tokenize([PROBE])
        if not (np.array_equal(np.asarray(ids), want_ids.numpy())
                and np.array_equal(np.asarray(mask).astype(bool),
                                   want_mask.numpy())):
            raise RuntimeError(
                f"the T5 conditioner does not tokenize with the hash: "
                f"{np.asarray(ids).tolist()} for {PROBE!r}, the reference "
                f"{want_ids.tolist()}")
