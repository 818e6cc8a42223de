"""The LLM/SSM model zoo of the port (``repro.models``' counterpart): the
dense GQA decoder (``transformer``), its MoE twin (``moe``), the
attention-free Mamba-2 family (``mamba2``), their primitives (``common``)
and the uniform :class:`~repro_torch.models.api.ModelAPI` (``api``)."""
