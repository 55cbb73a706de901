"""The LLM trainer CLI: ``python -m ptdeco_tpu_torch.apps.trainer_llm.run``
(tasks ``decompose_dwain`` and ``finetune``)."""
