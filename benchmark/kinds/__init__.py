"""General runners, one per kind of traffic; a mix in ``traffic/`` names its
kind and gives its parameters."""
