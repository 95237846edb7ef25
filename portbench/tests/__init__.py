"""CPU tests of the benchmark; the test marked ``cuda`` runs on the card.

    python -m pytest portbench/tests -q
    python3 -m pytest -c /dev/null --rootdir . portbench/tests -m cuda -q

(on the card, ``-c /dev/null`` skips the repository's pytest plugin, which
loads the JAX package for the CPU suite).
"""
