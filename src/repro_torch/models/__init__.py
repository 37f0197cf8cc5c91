"""Model substrates of the port: the CNN zoo of the paper's evaluation."""
