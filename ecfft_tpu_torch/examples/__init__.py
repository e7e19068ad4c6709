"""The port's examples, counterparts of ``examples/`` that import neither
jax nor ``ecfft_tpu``; each runs from the repository root as
``python -m ecfft_tpu_torch.examples.<name>``:

- ``interp_eval [log2_n] [batch] [--device cpu]``: a secp256k1 FFTree
  on the card, ENTER of a batch checked against naive evaluation, EXIT
  back to the coefficients;
- ``find_curve [k] [threads]``: FIND_CURVE over secp256k1's base field;
- ``schoof_large [max_bits]``: Schoof point counts over Mersenne-sized
  primes through the native engine.
"""
