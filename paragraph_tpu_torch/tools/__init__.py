"""Kernel benchmark tools of the port: ``kbench`` times the paired kernel
on one bench-shaped dispatch, ``kbench2`` runs the ablation ladder of its
column loop."""
