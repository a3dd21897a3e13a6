"""The benchmark's own pieces: yardstick, inputs, trace reduction, the
comparison, and the one module that builds the program."""
