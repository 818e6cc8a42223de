"""PyTorch + CUDA port of the ICSML fleet detector: ``repro``'s counterpart.

Mirrors ``repro``'s layout — ``configs``, ``core`` (layers, graph, model,
§6.1 quantization), ``kernels`` (hand-written Hopper kernels, their plain
PyTorch versions and the ``ops`` wrappers), ``sim`` (MSF plant simulator,
scenarios, detector heads and model builders) and ``serving`` (the fleet
``StreamEngine``) — plus ``bridge`` (param trees through numpy) and
``device``.  Imports torch and numpy only.
"""
