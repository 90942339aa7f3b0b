"""repro_torch.models: the LM stack's model definitions (counterpart of
``repro/models``): ``config``, ``layers``, ``attention``, ``moe``,
``model`` and ``runtime_flags``.  ``ssm.py`` comes with the ``ssm`` and
``hybrid`` families (ROADMAP queue A, item 15)."""
