"""The hand kernels' counts (kernels/<family>.py, one file a kernel),
found by file name: each holds PATTERN (the kernel's name in a device
trace), BOUND (which of the two bounds it sits under at the path's
shapes) and count(call) -> (operations, bytes) of a recorded call of its
plain version in the reference (reference/record.py)."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from typing import Dict, Iterable, Optional

from kdebench import peaks

KERNELS = Path(__file__).resolve().parent / "kernels"
# a trace's name of a kernel of the port's csrc/*.cu (each lives in an
# anonymous namespace of its own, not inside PyTorch's at::native)
PORT_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+_kernel)\b")


def load() -> Dict[str, object]:
    """family name -> its module, for every kernels/*.py."""
    out = {}
    for path in sorted(KERNELS.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"kdebench.kernels.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.PATTERN_RE = re.compile(mod.PATTERN)
        out[path.stem] = mod
    return out


def family_of(name: str, families: Dict[str, object]) -> Optional[str]:
    for fam, mod in families.items():
        if mod.PATTERN_RE.search(name):
            return fam
    return None


def least_by_family(calls: Iterable, families: Dict[str, object]) -> Dict[str, float]:
    """family -> the least seconds of its recorded calls, summed (each call
    bound by the larger of its operations and its bytes)."""
    out: Dict[str, float] = {}
    for call in calls:
        ops, nb = families[call.family].count(call)
        out[call.family] = out.get(call.family, 0.0) + peaks.least_s(ops, nb)[0]
    return out
