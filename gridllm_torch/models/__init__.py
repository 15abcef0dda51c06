"""Model families and their configs."""
