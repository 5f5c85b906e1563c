"""Out-of-tree extension ops — the WithFrameworkOutOfTreeRegistry analog.

The twin of the reference's ``engine/extensions.py`` (pkg/simulator/
simulator.go:188-195 registers out-of-tree plugins into the vendored
scheduler). An ExtensionOp contributes

  filter_fn(state, arrs, x) -> [N] bool   a feasibility mask, ANDed after
                                          the built-in filter pipeline and
                                          charged in the reason table under
                                          `name` (its own row, past the
                                          built-in ops);
  score_fn(state, arrs, x)  -> [N] f32    a raw score, weighted into the
                                          node ranking after the built-in
                                          rows; `normalize` picks the
                                          framework NormalizeScore
                                          treatment ("none" | "minmax" |
                                          "max").

The callables are torch functions. `state` is one lane's ``SimState``
carry as it stands before the pod (after the previous pod's bind), on the
step's device, in the reference's layout and dtypes (headroom, bf16
group_count / term_block under ``compact_carry``); `arrs` is the device
``SnapshotArrays``; `x` is the pod's slice: every pod-axis key of the
reference's ``_pod_xs`` (``engine/scheduler.POD_FIELDS``), ``_pod_index``
(the pod's index in the sequence), ``_disabled`` and ``_nominated`` (the
preemption columns; False and -1 without them), and ``gcr_gid`` /
``gcr_key`` where the step reads group_count columns. They return an [N]
bool mask or an [N] f32 score on that device.

They run once per pod, before the step: the engine evaluates them
against the live carry and hands the rows to the kernel
(``engine/scheduler._extension_scan``), each callable vmapped over the
lanes of a launch (``torch.func.vmap``), so they must be vmappable: torch
ops only, no ``.item()`` and no Python control flow on tensor values (the
reference's jit-traceability rule).

On the card the loop runs as a CUDA graph (the port's counterpart of the
reference tracing the callables into its ``lax.scan``): the first pod
runs eagerly, the second pod's work (the vmapped callables, the kernel
launch, the step of the device cursor that ``x`` is cut at) is captured,
and the graph is replayed for every later pod. So they must also be
capturable: torch ops on the card only, with no host round trip (no
``.item()``, ``.tolist()``, ``.cpu()``, printing a tensor,
``torch.tensor(...)`` or another copy from host memory), no
synchronisation and no new stream; a Python value a callable reads (a
global, a counter) is read once, at capture, and tensors it closes over
must live as long as the loop. A callable that breaks the rule is named
in a logged warning and the loop runs eagerly, a host round trip a pod
(``engine.scheduler.EXTENSION_LOOP["eager"]`` counts such loops); on the
CPU the loop always runs eagerly.

Usage (the reference's two worked examples)::

    import torch
    from open_simulator_tpu_torch.engine.extensions import ExtensionOp

    even_nodes_only = ExtensionOp(
        name="node(s) rejected by the even-index policy",
        filter_fn=lambda state, arrs, x: (
            torch.arange(arrs.alloc.shape[0], device=arrs.alloc.device) % 2 == 0))
    prefer_last_node = ExtensionOp(
        name="prefer-last-node",
        score_fn=lambda state, arrs, x: torch.arange(
            arrs.alloc.shape[0], dtype=torch.float32, device=arrs.alloc.device),
        normalize="minmax", weight=1000.0)
    cfg = make_config(snapshot, extensions=(even_nodes_only, prefer_last_node))

``simulate()`` and ``Simulator`` accept them through
``config_overrides={"extensions": ...}``, replay through
``ReplayOptions.config_overrides``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class ExtensionOp(NamedTuple):
    name: str
    filter_fn: Optional[Callable] = None
    score_fn: Optional[Callable] = None
    weight: float = 1.0
    normalize: str = "none"   # "none" (already 0..100) | "minmax" | "max"

    def validate(self) -> "ExtensionOp":
        if self.normalize not in ("none", "minmax", "max"):
            raise ValueError(f"ExtensionOp {self.name}: unknown normalize "
                             f"{self.normalize!r}")
        if self.filter_fn is None and self.score_fn is None:
            raise ValueError(f"ExtensionOp {self.name}: needs filter_fn "
                             f"and/or score_fn")
        return self
