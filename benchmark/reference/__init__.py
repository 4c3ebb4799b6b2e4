"""The plain reference, which imports torch and numpy only."""
