"""Training: schedule, optimizer, algorithms, train step and Trainer."""
