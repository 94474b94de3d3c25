"""Primitive-cost probes of the card: the ports of bench/primitives.py
(``primitives``) and exp/bench_mat2.py (``bench_mat2``)."""
