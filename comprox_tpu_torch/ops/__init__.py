"""Subpackage of comprox_tpu_torch (see the package docstring)."""
