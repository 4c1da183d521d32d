"""The Hungarian matcher and the set criterion of the Mask3D train step."""
