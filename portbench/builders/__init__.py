"""Dictionary builders, one module per name a configuration's `builder`
gives: `build(genomes, cfg, device)` lays the pan-genome dictionary out as
the program's bucket table on the device and returns (BucketedDict,
table)."""
