"""Typed exceptions for the public API surface.

A jax-free copy of ``ecfft_tpu/errors.py`` (same classes, tested). Each
type also inherits the builtin its call site would naturally raise
(ValueError/KeyError), so generic ``except ValueError`` handling keeps
working.
"""

from __future__ import annotations


class EcfftError(Exception):
    """Base class for every error raised by ecfft_tpu_torch."""


class UnknownFieldError(EcfftError, KeyError):
    """Field name not present in the registry (register it first with
    ``register_field`` / ``field_from_curve_search``)."""


class SizeError(EcfftError, ValueError):
    """Invalid transform/tree size (non-power-of-two, or larger than the
    tree — the reference's "FFTree is too small" panic, fftree.rs:494)."""


class CurveError(EcfftError, ValueError):
    """Invalid curve/point parameters (singular curve, non-residue B,
    point not on curve — the reference's constructor asserts,
    ec.rs:38-52)."""


class TreeConstructionError(EcfftError, ValueError):
    """FFTree construction failed an internal invariant (e.g. a rational
    map that is not 2-to-1 on its layer — the reference's debug_assert,
    fftree.rs:65)."""

