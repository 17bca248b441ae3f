"""Language-model substrate of the port: ``layers``, ``attention``,
``ssm`` (RWKV-6) and ``model`` (``forward_train``, ``lm_loss``)."""
