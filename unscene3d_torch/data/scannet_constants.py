"""The ScanNet20 class ids and the ScanNet200 head / common / tail category
splits (the port's own copy of those tuples of
unscene3d_tpu/data/scannet_constants.py;
datasets/scannet200/scannet200_splits.py:3-5). `Experiment.fit` reports the
mean AP of each split over the classes it evaluates
(trainer/trainer.py:861-870); the class-agnostic freemask preset has none of
them.
"""

# the nyu40 ids of the 20 benchmark classes
VALID_CLASS_IDS_20 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

HEAD_CATS_SCANNET_200 = (
    "tv stand", "curtain", "blinds", "shower curtain", "bookshelf", "tv",
    "kitchen cabinet", "pillow", "lamp", "dresser", "monitor", "object",
    "ceiling", "board", "stove", "closet wall", "couch", "office chair",
    "kitchen counter", "shower", "closet", "doorframe", "sofa chair",
    "mailbox", "nightstand", "washing machine", "picture", "book", "sink",
    "recycling bin", "table", "backpack", "shower wall", "toilet", "copier",
    "counter", "stool", "refrigerator", "window", "file cabinet", "chair",
    "wall", "plant", "coffee table", "stairs", "armchair", "cabinet",
    "bathroom vanity", "bathroom stall", "mirror", "blackboard", "trash can",
    "stair rail", "box", "towel", "door", "clothes", "whiteboard", "bed",
    "floor", "bathtub", "desk", "wardrobe", "clothes dryer", "radiator",
    "shelf",
)

COMMON_CATS_SCANNET_200 = (
    "cushion", "end table", "dining table", "keyboard", "bag",
    "toilet paper", "printer", "blanket", "microwave", "shoe",
    "computer tower", "bottle", "bin", "ottoman", "bench", "basket", "fan",
    "laptop", "person", "paper towel dispenser", "oven", "rack", "piano",
    "suitcase", "rail", "container", "telephone", "stand", "light",
    "laundry basket", "pipe", "seat", "column", "bicycle", "ladder",
    "jacket", "storage bin", "coffee maker", "dishwasher", "machine", "mat",
    "windowsill", "bulletin board", "fireplace", "mini fridge",
    "water cooler", "shower door", "pillar", "ledge", "furniture", "cart",
    "decoration", "closet door", "vacuum cleaner", "dish rack", "range hood",
    "projector screen", "divider", "bathroom counter", "laundry hamper",
    "bathroom stall door", "ceiling light", "trash bin", "bathroom cabinet",
    "structure", "storage organizer", "potted plant", "mattress",
)

TAIL_CATS_SCANNET_200 = (
    "paper", "plate", "soap dispenser", "bucket", "clock", "guitar",
    "toilet paper holder", "speaker", "cup", "paper towel roll", "bar",
    "toaster", "ironing board", "soap dish", "toilet paper dispenser",
    "fire extinguisher", "ball", "hat", "shower curtain rod", "paper cutter",
    "tray", "toaster oven", "mouse", "toilet seat cover dispenser",
    "storage container", "scale", "tissue box", "light switch", "crate",
    "power outlet", "sign", "projector", "candle", "plunger",
    "stuffed animal", "headphones", "broom", "guitar case", "dustpan",
    "hair dryer", "water bottle", "handicap bar", "purse", "vent",
    "shower floor", "water pitcher", "bowl", "paper bag", "alarm clock",
    "music stand", "laundry detergent", "dumbbell", "tube", "cd case",
    "closet rod", "coffee kettle", "shower head", "keyboard piano",
    "case of water bottles", "coat rack", "folded chair", "fire alarm",
    "power strip", "calendar", "poster", "luggage",
)
