"""Contract checks over the ops a round runs.

The reference reads its contracts off the compiled HLO of each jitted
dispatch (``repro/analysis/hlo_checks.py``).  The port has no HLO: its
round is eager PyTorch, so the checks read the ops themselves, through a
``TorchDispatchMode`` that sees every aten op the round issues, on the
CPU as on the card:

1. **host-op** — no op that makes the host wait for the card outside a
   ``host_readback`` seam: ``aten._local_scalar_dense`` / ``aten.item``
   (``.item()``, ``float(t)``, ``bool(t)``), the ops whose output size
   is read back (``nonzero``, ``masked_select``, ``unique``), and a
   device-to-host ``copy_`` / ``_to_copy`` that blocks (one into pageable
   memory; a non-blocking copy into pinned memory queues and does not
   wait).  It is the zero-sync contract, tested on the CPU as well as by
   the card's sync debug mode.
2. **no-f64** — no float64 op output outside ``_RoundLedger.push``, whose
   float64 row is deliberate (its counts and float32 values are exact
   there).
3. **in-place** — the round writes that the port does in place (today
   the cohort scatters into the caches and the stateful rule's (N,)
   state, ``core/caching.py``) keep their storage across rounds: the
   counterpart of the reference's donation check (:class:`InPlaceWatch`).

The mesh-only HLO checks (psum dtype, partition count, input shardings)
belong to ROADMAP Queue A #17 (multi-device).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import in_host_readback
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Finding:
    """One broken contract, tied to the round-path function at fault."""
    where: str
    contract: str        # "host-op" | "no-f64" | "in-place" | "transfer"
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.where}: {self.message}"


#: ops that read a value, or their output's size, back to the host
HOST_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "masked_select", "unique",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
})
#: the one function allowed float64 outputs (qualified name)
F64_SITE = "_RoundLedger.push"
_HERE = __file__


def _blocking_d2h(name: str, args, kwargs) -> bool:
    """Is this op a device-to-host copy that waits for the card?"""
    if name == "copy_" and len(args) >= 2:
        dst, src = args[0], args[1]
        non_blocking = kwargs.get("non_blocking",
                                  args[2] if len(args) > 2 else False)
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dst.device.type == "cpu"
                and not (non_blocking and dst.is_pinned()))
    if name == "_to_copy" and args:
        src, dev = args[0], kwargs.get("device")
        return (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                and dev is not None and torch.device(dev).type == "cpu"
                and not (kwargs.get("non_blocking") and
                         kwargs.get("pin_memory")))
    return False


def _f64(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.dtype == torch.float64
    if isinstance(out, (tuple, list)):
        return any(_f64(o) for o in out)
    return False


def _frames():
    f = sys._getframe(1)
    while f is not None:
        yield f
        f = f.f_back


def _qualname(code) -> str:
    return getattr(code, "co_qualname", code.co_name)


def _caller() -> str:
    """The innermost frame outside torch and this module: the code that
    issued the op."""
    for f in _frames():
        path = f.f_code.co_filename
        if path == _HERE or "/torch/" in path.replace("\\", "/"):
            continue
        return (f"{_qualname(f.f_code)} "
                f"({path.rsplit('/', 1)[-1]}:{f.f_lineno})")
    return "<unknown>"


def _in_f64_site() -> bool:
    return any(_qualname(f.f_code) == F64_SITE for f in _frames())


class OpChecks(TorchDispatchMode):
    """Records the host-op and no-f64 findings of the ops run while it is
    active::

        with OpChecks() as oc:
            engine.run("flude", rounds=2, diagnostics=False)
        assert not oc.findings

    ``ops`` counts the aten ops seen.  Each finding is recorded once per
    (contract, place)."""

    def __init__(self):
        super().__init__()
        self.findings: List[Finding] = []
        self.ops = 0
        self._seen = set()

    def _add(self, contract: str, message: str) -> None:
        where = _caller()
        if (contract, where, message) in self._seen:
            return
        self._seen.add((contract, where, message))
        self.findings.append(Finding(where, contract, message))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        name = func.overloadpacket.__name__
        if not in_host_readback():
            if name in HOST_OPS:
                self._add("host-op", f"aten.{name} reads back to the host "
                          f"outside host_readback")
            elif _blocking_d2h(name, args, kwargs):
                self._add("host-op", f"aten.{name}: a device-to-host copy "
                          f"that waits, outside host_readback")
        if _f64(out) and not _in_f64_site():
            self._add("no-f64", f"aten.{name} has a float64 output "
                      f"outside {F64_SITE}")
        return out


class InPlaceWatch:
    """Holds the engine's in-place round writes to their storage.

    It wraps the engine's memoised server steps (they return the caches
    and, for a stateful rule, its state); on the cohort path, whose
    scatters write those in place, every step's output leaves must keep
    the storage of the run's first round.  ``close()`` restores the
    steps and returns the findings.  On the full scan nothing is written
    in place and nothing is checked."""

    def __init__(self, engine):
        self.engine = engine
        self._orig = dict(engine._server_steps)
        self._ptrs: Optional[list] = None
        self.findings: List[Finding] = []
        if engine.cohort is None:
            return
        for key, step in self._orig.items():
            engine._server_steps[key] = self._wrap(step)

    def _wrap(self, step):
        stateful = self.engine._agg_stateful

        def watched(*args):
            out = step(*args)
            caches = out[1]
            leaves = [("caches.progress", caches.progress),
                      ("caches.round_stamp", caches.round_stamp)]
            leaves += [(f"caches.params[{i}]", leaf) for i, leaf in
                       enumerate(tree_leaves(caches.params))]
            if stateful:
                leaves.append(("rule_state", out[-1]))
            ptrs = [(n, t.untyped_storage().data_ptr()) for n, t in leaves]
            if self._ptrs is None:
                self._ptrs = ptrs
            else:
                for (name, want), (_, got) in zip(self._ptrs, ptrs):
                    if got != want:
                        self.findings.append(Finding(
                            "server_step", "in-place",
                            f"{name} moved to new storage in a later "
                            f"round — the cohort scatter must write it "
                            f"in place"))
            return out
        return watched

    def close(self) -> List[Finding]:
        self.engine._server_steps.update(self._orig)
        return self.findings
