"""Problem generators: frozen numpy copies of the port's synthetic problems.

Each module has `make(config, seed) -> Problem`. A generator depends on
numpy alone, so a change to the port cannot move the inputs.
"""
