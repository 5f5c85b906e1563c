"""Lanes of new-node counts: the capacity sweep and its bisection."""
