"""The capacity planner ("simon apply") on the port's engine."""
