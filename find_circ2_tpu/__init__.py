"""GPU circRNA detection engine in JAX (find_circ2 capabilities, rebuilt).

See SURVEY.md for the structural analysis of the reference pipeline and
SPEC.md for the frozen algorithm this package implements.
"""

__version__ = "0.1.0"
