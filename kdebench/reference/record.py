"""Which of the reference's plain calls the port runs as hand kernels, and
on what.

Each plain version that stands for a hand kernel of the port
(ops/cuda_*.py here) is wrapped by `recorded(family, fn)`.  Inside
`recording()` every outermost call of such a function appends a Call
(family, arguments, result) to the list it yields: the launch shapes and
the data that kdebench/kernels/<family>.py count the kernel's operations
and bytes from.  A call made inside another recorded call (the NASP sums'
own gathers) is part of the outer one and is not appended.  Outside
`recording()` nothing is kept.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional


class Call(NamedTuple):
    family: str
    args: tuple
    kwargs: Dict[str, Any]
    result: Any


_log: Optional[List[Call]] = None
_depth = 0


@contextlib.contextmanager
def recording() -> Iterator[List[Call]]:
    global _log
    prev, _log = _log, []
    try:
        yield _log
    finally:
        _log = prev


def recorded(family: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(*args, **kwargs):
        global _depth
        _depth += 1
        try:
            result = fn(*args, **kwargs)
        finally:
            _depth -= 1
        if _log is not None and _depth == 0:
            _log.append(Call(family, args, kwargs, result))
        return result

    return call
