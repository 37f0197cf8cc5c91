"""Model substrates of the port: the CNN zoo of the paper's evaluation,
the transformer decoders (the assigned archs), and ``graph_export``,
which turns a decoder into a PICO graph for the planner."""
