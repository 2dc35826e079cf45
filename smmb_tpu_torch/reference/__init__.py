"""Plain float32 statements of the port's models, for the tests: plain
``torch`` operations on the masters, importing nothing else of the port."""
