"""Data of the port: image files (``imageio``), the YOLO-format dataset and its
batch loader (``dataset``), and the copy of batches to the card (``prefetch``)."""
