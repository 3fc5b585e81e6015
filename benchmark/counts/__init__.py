"""The yardstick's arithmetic: the card's published peaks, each kernel's
least bytes and operations, and the model's operations a read."""
