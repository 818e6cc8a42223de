"""Configurations of the port: the §7 detector's constants
(``msf_detector``), the paper's §5–6 layer sizes (``icsml_mlp``) and the
architecture registry (``base``; the dense ``qwen3_8b``, ``command_r_35b``,
``command_r_plus_104b`` and ``nemotron_4_340b``, the moe
``granite_moe_1b_a400m`` and ``mixtral_8x22b``, the ssm ``mamba2_370m``, the
hybrid ``jamba_1_5_large_398b``, the vlm ``llava_next_34b`` and the audio
``whisper_base``)."""
