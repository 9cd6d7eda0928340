"""One module a traffic kind (``perfbench/kinds/<kind>.py``), found by the
``kind`` of the cell's traffic file."""
