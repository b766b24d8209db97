"""Transforms: the Hopper row kernel, the plain mixed-radix path and the functional API."""
