"""Training: AdamW with quantized moments, the train step, the trainer."""
