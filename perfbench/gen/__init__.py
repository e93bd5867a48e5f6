"""The benchmark's yardstick: frozen copies of the port's generator, key
tree and traffic model, held to the originals by
``perfbench/tests/test_perfbench_frozen.py``."""
