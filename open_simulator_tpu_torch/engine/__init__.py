"""The engine: config, carry, the plain step and schedule_pods (scheduler),
the DefaultPreemption pass (preemption) and the queue order (queue)."""
