"""Device ops of dampr_tpu_torch: hashing, the hand-written kernels
(:mod:`.fnv`, :mod:`.segfold`), text scanners, segment folds and the
lowered token-fold program."""
