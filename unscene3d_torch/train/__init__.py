"""The Mask3D train step: AdamW with the reference's schedules, and the
Trainer that runs forward, criterion, backward and the update."""
