"""PET models: the small 3D CNN and the Med3D ResNet on the PET volume."""
