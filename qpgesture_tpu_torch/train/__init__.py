"""Training-side helpers of the port (only the dataset statistics the
database builder needs so far)."""
