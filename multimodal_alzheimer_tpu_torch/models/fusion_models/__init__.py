"""Stage-2 fusion models: MRI+PET, MRI+tabular and PET+tabular."""
