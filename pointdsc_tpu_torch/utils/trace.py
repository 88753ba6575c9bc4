"""Named spans on the profiler's clock.

``span(name)`` labels a block of host code for whatever ``torch.profiler``
session is running, so that each device operation launched inside it, and
each stretch of device idle time while it is open, can be put down to the
program stage that caused it. The running profiler is the only collector:
it keeps the spans in memory beside the device operations and hands them
out with its events. With no profiler running a span is one shared null
context (under a microsecond); ``record_function`` alone costs ~13 us.

Span names start with ``pointdsc.``; ``tools/profile_forward.py::span_times``
reduces a profiler's events to device and idle time by span.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str, args: str | None = None):
    """A ``record_function(name, args)`` while a profiler runs, else a null
    context. ``args`` is recorded where the profiler records inputs."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.autograd.profiler.record_function(name, args)
