"""open-simulator-tpu on PyTorch and CUDA: the port of the JAX package
``open_simulator_tpu`` to an NVIDIA H100.

The host layers (k8s object model, workload expansion, snapshot encoding,
admission) are copies of the reference's, so both packages encode a
cluster into the same arrays. The engine is rewritten in torch: a plain
torch twin of the reference's scan step, and a hand-written CUDA kernel
(``csrc/plain_step.cu``) that runs the whole pod loop on the card.

Entry points (``core.simulate``, the ``simulator.Simulator`` session
facade, ``engine.scheduler.schedule_pods`` and ``schedule_lanes``,
``parallel.sweep.capacity_sweep`` and ``capacity_bisect``, and
``python -m open_simulator_tpu_torch.cli apply``) run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
