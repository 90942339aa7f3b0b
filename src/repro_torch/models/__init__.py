"""repro_torch.models: the LM stack's model definitions (counterpart of
``repro/models``): ``config``, ``layers``, ``attention``, ``moe``,
``model``, ``ssm`` and ``runtime_flags``, for every family of the
reference: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec`` and
``vlm``."""
