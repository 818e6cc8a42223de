"""Launchers of the port (``repro.launch``'s counterpart): ``serve``, the
LLM serving command line; ``train``, the LLM training command line, and
``steps``, its train step.  Meshes and the dry-run wait for multi-device
work (ROADMAP §1 item 2)."""
