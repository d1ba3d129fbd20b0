"""The LLM cascade: decoder LM, LoRA, quantization, tokenizer, evaluation."""
