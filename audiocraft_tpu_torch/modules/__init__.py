"""Building blocks: transformer, conditioners, patterns, T5 and the codec's
SEANet stack."""
