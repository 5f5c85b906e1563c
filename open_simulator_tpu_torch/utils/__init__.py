"""Host utilities: checkpoint and resume."""
