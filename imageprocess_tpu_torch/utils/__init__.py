"""Cross-cutting utilities: profiling, the environment self-check."""

from .profiling import maybe_profile  # noqa: F401
