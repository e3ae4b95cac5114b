SELECT id6, subvec(v3, 0, 2) AS largest2_v3 FROM source ASSUMING DESC v3 GROUP BY id6;
