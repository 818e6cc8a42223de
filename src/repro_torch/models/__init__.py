"""The LLM/SSM model zoo of the port (``repro.models``' counterpart): the
attention-free Mamba-2 family (``mamba2``), its primitives (``common``) and
the uniform :class:`~repro_torch.models.api.ModelAPI` (``api``)."""
