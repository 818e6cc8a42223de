"""The port's user entry points: the counterparts of the scripts under
``examples/``, one module each, with the same flags, defaults and printed
lines, plus ``--device`` (default ``cuda``; without a card it raises, never
falling back to the CPU; ``--device cpu`` runs the plain PyTorch path).

* ``detect_fleet`` — train, port, quantize, then serve the scenario library
  through ``StreamEngine`` / ``GroupedStreamEngine`` (``--devices N`` over N
  spawned ranks on a ``("data",)`` mesh) and print the per-plant table.
* ``casestudy_msf`` — the paper's §7 case study: test accuracy, detection
  latency of an unseen attack, the §7.2 Wd non-intrusiveness check.
* ``export_st`` — the IEC 61131-3 export of a detector, verified against the
  fleet engine before it ships.
* ``quickstart`` — the ICSML core in five steps.
* ``serve_llm`` / ``train_llm`` — LLM serving and training.

Run each as ``python -m repro_torch.examples.<name> ...`` with ``src`` on
``PYTHONPATH``.  Every module exposes ``main(argv=None)`` and the functions
its steps are made of.
"""
