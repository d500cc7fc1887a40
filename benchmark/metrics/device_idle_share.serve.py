"""The device's idle share of the traced slice, in %: 1 - (the union of
every kernel's, copy's and set's interval) / the slice's wall time."""

from benchmark.harness import idle_share as read  # noqa: F401
