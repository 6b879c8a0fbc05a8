"""AdamW and the learning-rate schedule of the trainer."""
