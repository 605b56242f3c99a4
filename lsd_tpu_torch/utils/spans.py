"""Named spans of the port, as ``torch.profiler`` annotations.

Every span of the package goes through ``span(name)``.  While a profiler
records, it is ``record_function(name)``: the span shares the profiler's
clock with the host operators, the runtime calls and the device events, so
a trace puts every launch, sync and idle gap under the innermost span.
Otherwise it is one shared ``nullcontext``: ``record_function`` dispatches
an operator on entry and on exit even when nothing records, about 15 us a
span on a host CPU, where the check costs under a microsecond.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` in a profiler's trace, or does
    nothing when no profiler records."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return NO_SPAN
