"""Config file schema (simon/v1alpha1 Config parity)."""
