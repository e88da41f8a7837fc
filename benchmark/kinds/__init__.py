"""Kinds of configuration: what a configuration file's ``kind`` names.
Each module makes its inputs from the seed, drives the program through its
entry point, and computes the reference and the kernels' bound."""
