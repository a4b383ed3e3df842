"""Input generators: every input of a run is drawn from its ``--seed``."""
