"""Configurations of the port: the §7 detector's constants
(``msf_detector``), the paper's §5–6 layer sizes (``icsml_mlp``) and the
architecture registry (``base``; ``mamba2_370m``)."""
