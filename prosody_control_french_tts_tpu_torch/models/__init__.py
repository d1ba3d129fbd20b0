"""The prosody predictors: the LLM cascade (decoder LM, LoRA, quantization,
evaluation), the BERT break tagger and sentence encoder, the BiLSTM prosody
regressor, their trainers and experiment drivers, the few-shot harness, the
datasets built from bdd.json, and the WordPiece tokenizer."""
