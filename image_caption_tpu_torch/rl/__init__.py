"""Self-critical (SCST) fine-tuning: rewards, loss and train step."""
